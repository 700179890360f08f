"""RMVB: the robust Capon (robust MVDR) beamformer (counterpart of
azoom.beam.rmvb; Li, Stoica & Wang 2003).

MVDR self-cancels the target when the look direction is only roughly
right. RMVB maximises the output power over every steering vector inside
the sphere ||a - a_bar||^2 <= eps, which reduces to

    a_hat = a_bar - (I + lambda R)^-1 a_bar,
    g(lambda) = ||(I + lambda R)^-1 a_bar||^2 = eps,

then the ordinary MVDR solve with a_hat. In R's eigenbasis g is a sum over
the eigenvalues and decreases in lambda, so the root is a fixed 30-step
bisection, batched over every bin: the closed-form 2x2 EVD at M = 2, the
Jacobi EVD of beam.linalgmm above.

complex64 throughout, in the reference's order of operations: the bisection
steps and the ``has_root`` and ``use_nominal`` guards compare float32
values.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalgmm import eigh_hermitian_small
from azoom_torch.beam.mvdr import apply_weights, mvdr_weights

__all__ = ["rmvb_weights", "rmvb_beamform"]

_BISECT_ITERS = 30


def _sum_norm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x) ** 2, dim=-1, keepdim=True)


def rmvb_weights(
    R: torch.Tensor,
    d: torch.Tensor,
    eps_uncertainty: float = 0.5,
    sigma: float = 1e-7,
    R_solve: torch.Tensor | None = None,
    correction_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Robust Capon weights (..., F, M), distortionless toward the corrected
    steering vector.

    R: (..., F, M, M) Hermitian covariance that contains the signal of
    interest (it corrects the steering). d: (..., F, M) nominal steering
    (||d||^2 = M). ``eps_uncertainty``: the sphere's squared radius (capped
    at 0.9 ||d||^2). ``R_solve``: the covariance of the final MVDR solve
    (default R). ``correction_weight``: (..., 1) per-bin blend between the
    nominal (0) and the corrected steering (1). Bins where the bracket has
    no root, or where the correction collapses, keep the nominal steering;
    the corrected vector is rescaled to the nominal norm."""
    gam, U = eigh_hermitian_small(R)
    gam = torch.clamp(gam, min=0.0)
    b = torch.einsum("...ij,...i->...j", torch.conj(U), d)  # U^H d
    b2 = (b * torch.conj(b)).real

    def g(lam):
        return torch.sum(b2 / (1.0 + lam[..., None] * gam) ** 2, dim=-1)

    norm2 = torch.sum(b2, dim=-1)  # = ||d||^2
    eps = torch.clamp(0.9 * norm2, max=eps_uncertainty)
    gmax = torch.clamp(gam[..., -1], min=1e-30)
    gmin_pos = torch.maximum(gam[..., 0], 1e-6 * gmax)
    lam_hi = torch.clamp((torch.sqrt(norm2 / eps) - 1.0) / gmin_pos, min=0.0)
    # no root (a near-rank-1 R: g tends to the small eigenvector's b2 above
    # eps): keep the nominal steering there
    has_root = g(lam_hi) <= eps
    lo = torch.zeros_like(lam_hi)
    hi = lam_hi
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        too_big = g(mid) > eps  # g decreasing: lambda must grow
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)

    b_corr = b * (1.0 - 1.0 / (1.0 + lam[..., None] * gam)).to(b.dtype)
    a_hat = torch.einsum("...ij,...j->...i", U, b_corr)
    a_hat = torch.where(has_root[..., None], a_hat, d)
    use_nominal = _sum_norm2(a_hat) < 1e-8 * _sum_norm2(d)
    a_hat = torch.where(use_nominal, d, a_hat)
    if correction_weight is not None:
        a_hat = correction_weight * a_hat + (1.0 - correction_weight) * d
    a_hat = a_hat * torch.sqrt(_sum_norm2(d) / torch.clamp(_sum_norm2(a_hat), min=1e-30))
    return mvdr_weights(R if R_solve is None else R_solve, a_hat, sigma=sigma)


def rmvb_beamform(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    eps_uncertainty: float = 0.5,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
) -> torch.Tensor:
    """Masked RMVB on an STFT block (..., M, F, T) -> (..., F, T), bins below
    ``hp_cutoff_hz`` zero; ``d`` (F, M) or (..., F, M).

    The steering correction sees the target-weighted covariance (from
    1 - noise_mask), the distortionless solve the noise-weighted one; the
    correction is blended per bin by the target dominance
    q = tr(R_sig) / (tr(R_sig) + tr(R_noise)), so bins without target
    evidence keep the nominal steering."""
    R_noise = masked_covariance(Y, noise_mask)
    R_sig = masked_covariance(Y, 1.0 - noise_mask)

    def tr(R):
        return torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real

    q = tr(R_sig) / (tr(R_sig) + tr(R_noise) + 1e-30)
    w = rmvb_weights(R_sig, d, eps_uncertainty, sigma, R_solve=R_noise,
                     correction_weight=q[..., None])
    S = apply_weights(w, Y)
    keep = (freqs_hz >= hp_cutoff_hz)[:, None]
    return torch.where(keep, S, torch.zeros((), dtype=S.dtype, device=S.device))
