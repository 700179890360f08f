"""GEV / max-SNR beamformers and their field-of-view variant (counterpart of
azoom.beam.gev).

The max-SNR (= GEV) weights maximise (w^H R_tgt w) / (w^H R_noise w): the
principal generalized eigenvector of the pencil (R_tgt, R_noise). At M = 2
it is the principal eigenvector of the general 2x2 matrix R_noise^-1 R_tgt,
in closed form (:func:`eig_principal_2x2`); at M > 2 a 12-step power
iteration on the same product, one Cholesky solve of beam.linalgmm a step
(:func:`gev_principal_power`). The per-bin complex scale is fixed by Blind
Analytic Normalization (Warsitz & Haeb-Umbach 2007) or a distortionless
projection onto the target steering vector. The field-of-view variant
replaces the target covariance by the steering covariance averaged over
the zoom window.

Every function runs in complex64 on the device of its input, in the
reference's order of operations: the gates of :func:`eig_principal_2x2`
(which root, which row, degenerate or not) compare float32 values.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import csqrt_cut, solve_2x2_hermitian
from azoom_torch.beam.linalgmm import solve_hermitian_small
from azoom_torch.dsp.delays import steering_vector

__all__ = [
    "eig_principal_2x2",
    "gev_principal_power",
    "gev_weights",
    "fov_target_covariance",
    "max_snr_fov_beamform",
    "gev_beamform",
]


def eig_principal_2x2(A: torch.Tensor, eps: float = 1e-12, rel_tol: float = 1e-6) -> torch.Tensor:
    """Principal (largest |lambda|) eigenvector of a general complex 2x2
    matrix (..., 2, 2), closed form, unit norm.

    Degeneracy (A ~ isotropic, the eigenbasis arbitrary) is judged RELATIVE
    to the matrix scale |a| + |b| + |c| + |d|: the longer of the two row
    candidates shorter than rel_tol x scale falls back to e0."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    tr = a + d
    det = a * d - b * c
    disc = csqrt_cut(tr * tr - 4.0 * det)
    lam1 = 0.5 * (tr + disc)
    lam2 = 0.5 * (tr - disc)
    lam = torch.where(torch.abs(lam1) >= torch.abs(lam2), lam1, lam2)
    # (A - lam I) v = 0 from row 0 or from row 1: take the longer one.
    v1 = torch.stack([b, lam - a], dim=-1)
    v2 = torch.stack([lam - d, c], dim=-1)
    n1 = torch.sum(torch.abs(v1) ** 2, dim=-1, keepdim=True)
    n2 = torch.sum(torch.abs(v2) ** 2, dim=-1, keepdim=True)
    v = torch.where(n1 >= n2, v1, v2)
    nsq = torch.sum(torch.abs(v) ** 2, dim=-1, keepdim=True)
    scale = torch.abs(a) + torch.abs(b) + torch.abs(c) + torch.abs(d)
    degenerate = nsq <= (rel_tol * scale[..., None]) ** 2 + eps * eps
    nv = torch.sqrt(torch.where(degenerate, torch.ones_like(nsq), nsq))
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    return torch.where(degenerate, e0, v / nv)


def gev_principal_power(R_tgt: torch.Tensor, Rn: torch.Tensor, iters: int = 12,
                        eps: float = 1e-12) -> torch.Tensor:
    """Principal generalized eigenvector of the Hermitian PSD pencil
    (R_tgt, Rn) (..., M, M) for any M, by ``iters`` power steps on
    Rn^-1 R_tgt from the all-ones vector; inputs trace-normalised O(1).
    A step whose image collapses (norm <= eps: an all-but-zero R_tgt) keeps
    the previous direction. Returns unit-norm (..., M)."""
    M = Rn.shape[-1]
    inv = 1.0 / torch.sqrt(torch.full((), float(M), dtype=Rn.real.dtype, device=Rn.device))
    v = torch.ones(Rn.shape[:-1], dtype=Rn.dtype, device=Rn.device) * inv
    for _ in range(iters):
        u = torch.einsum("...ij,...j->...i", R_tgt, v)
        w = solve_hermitian_small(Rn, u)
        nrm = torch.sqrt(torch.sum(torch.abs(w) ** 2, dim=-1, keepdim=True))
        v = torch.where(nrm > eps, w / torch.clamp(nrm, min=eps), v)
    return v


def gev_weights(
    R_tgt: torch.Tensor,
    R_noise: torch.Tensor,
    d_tgt: torch.Tensor | None = None,
    sigma: float = 1e-7,
    normalization: str = "ban",
    eps: float = 1e-10,
) -> torch.Tensor:
    """Max-SNR weights (..., F, M) from Hermitian covariances (..., F, M, M).

    Both covariances are trace-normalised before the eigenvector (it is
    invariant to a per-bin scale of either, and O(1) entries keep the
    determinant in float32 range on quiet bins). ``normalization``: 'ban'
    (blind analytic normalization), 'distortionless' (w^H d_tgt = 1; needs
    ``d_tgt`` (..., F, M)) or 'none'."""
    M = R_noise.shape[-1]
    eye = torch.eye(M, dtype=R_noise.dtype, device=R_noise.device)
    Rn = R_noise + sigma * eye
    t_n = torch.diagonal(Rn.real, dim1=-2, dim2=-1).sum(-1) / M
    t_t = torch.diagonal(R_tgt.real, dim1=-2, dim2=-1).sum(-1) / M
    Rn_h = Rn / torch.clamp(t_n, min=1e-30)[..., None, None]
    Rt_h = (R_tgt / torch.clamp(t_t, min=1e-30)[..., None, None]).to(Rn.dtype)
    if M == 2:
        col0 = solve_2x2_hermitian(Rn_h, Rt_h[..., :, 0], eps=1e-10)
        col1 = solve_2x2_hermitian(Rn_h, Rt_h[..., :, 1], eps=1e-10)
        w = eig_principal_2x2(torch.stack([col0, col1], dim=-1))
    else:
        w = gev_principal_power(Rt_h, Rn_h)

    if normalization == "ban":
        # gain = sqrt(w^H Rn Rn w / M) / (w^H Rn w)  (Warsitz 2007, eq. 27)
        Rn_w = torch.einsum("...fij,...fj->...fi", Rn, w)
        num = torch.sqrt(torch.clamp(torch.sum(torch.abs(Rn_w) ** 2, dim=-1) / M, min=0.0))
        den = torch.einsum("...fi,...fi->...f", torch.conj(w), Rn_w).real
        w = w * (num / (den + eps))[..., None]
    elif normalization == "distortionless":
        if d_tgt is None:
            raise ValueError("distortionless normalization needs d_tgt")
        g = torch.sum(torch.conj(w) * d_tgt, dim=-1, keepdim=True)
        w = w * torch.conj(g) / (torch.abs(g) ** 2 + eps)
    elif normalization != "none":
        raise ValueError(f"unknown normalization {normalization!r}")
    return w


def fov_target_covariance(
    freqs_hz: torch.Tensor,
    center_deg: float,
    fov_deg: float,
    mic_dist: float,
    c: float = 343.0,
    n_mics: int = 2,
    n_points: int = 9,
) -> torch.Tensor:
    """Steering covariance averaged over a field of view, complex64 (F, M, M):
    R_fov[f] = mean_theta d(f, theta) d(f, theta)^H over ``n_points``
    azimuths spanning [center - fov/2, center + fov/2]: small fov, tight zoom."""
    offsets = torch.linspace(-fov_deg / 2.0, fov_deg / 2.0, n_points, dtype=torch.float32,
                             device=freqs_hz.device)
    D = steering_vector(freqs_hz, center_deg + offsets, mic_dist, c, n_mics)  # (A, F, M)
    return torch.einsum("afm,afn->fmn", D, torch.conj(D)) / n_points


def gev_beamform(
    Y: torch.Tensor,
    target_mask: torch.Tensor,
    sigma: float = 1e-7,
    normalization: str = "ban",
    d_tgt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mask-driven GEV: R_tgt from the target mask, R_noise from its
    complement, max-SNR weights applied. Y (..., M, F, T) -> (..., F, T)."""
    R_tgt = masked_covariance(Y, target_mask)
    R_noise = masked_covariance(Y, 1.0 - target_mask)
    w = gev_weights(R_tgt, R_noise, d_tgt, sigma, normalization)
    return torch.einsum("...fm,...mft->...ft", torch.conj(w), Y)


def max_snr_fov_beamform(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    freqs_hz: torch.Tensor,
    center_deg: float,
    fov_deg: float,
    mic_dist: float,
    c: float = 343.0,
    sigma: float = 1e-7,
) -> torch.Tensor:
    """FOV-constrained max-SNR: the target covariance is the steering
    average over the zoom window (:func:`fov_target_covariance`), the noise
    covariance the noise-masked one; distortionless toward the centre.
    Y (..., M, F, T) -> (..., F, T)."""
    M = Y.shape[-3]
    R_fov = fov_target_covariance(freqs_hz, center_deg, fov_deg, mic_dist, c, M)
    R_noise = masked_covariance(Y, noise_mask)
    d0 = steering_vector(freqs_hz, center_deg, mic_dist, c, M)
    w = gev_weights(R_fov.to(Y.dtype), R_noise, d0, sigma, "distortionless")
    return torch.einsum("...fm,...mft->...ft", torch.conj(w), Y)
