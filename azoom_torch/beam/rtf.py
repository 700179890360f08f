"""RTF-steered MVDR: steering measured from the data (counterpart of
azoom.beam.rtf).

The relative transfer function is estimated by covariance whitening: the
principal generalized eigenvector v of the masked pencil (R_tgt, R_noise),
de-whitened a = R_noise v and normalised to mic 0, a = [1, h(f), ...]. MVDR
with w^H a = 1 then keeps the target as the reference mic heard it,
reflections and spacing errors included. A per-bin confidence (the
separation of the generalized eigenvalues) gates a fallback to the
geometric steering where the data does not pin the RTF down.

complex64 throughout, in the reference's order of operations: the gate
``conf >= conf_thresh`` picks a whole bin's steering.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.gev import eig_principal_2x2, gev_principal_power
from azoom_torch.beam.linalg2x2 import csqrt_cut, solve_2x2_hermitian
from azoom_torch.beam.linalgmm import solve_hermitian_small
from azoom_torch.beam.mvdr import apply_weights, mvdr_weights

__all__ = ["rtf_from_covariances", "rtf_mvdr_beamform"]


def _trace(R: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(R.real, dim1=-2, dim2=-1).sum(-1)


def rtf_from_covariances(
    R_tgt: torch.Tensor,
    R_noise: torch.Tensor,
    ref_floor: float = 0.1,
    load: float = 1e-6,
    eps: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin RTF steering vectors by covariance whitening.

    R_tgt, R_noise: (..., F, M, M) Hermitian masked covariances; R_noise is
    loaded by ``load`` x its trace. M = 2 takes the closed-form pencil eig;
    M > 2 the whitened power iteration (beam.gev), with the confidence from
    the principal Rayleigh quotient against the mean of the rest of the
    generalized spectrum (the 2x2 definition at M = 2). ``ref_floor``: the
    smallest reference-mic magnitude, relative to the vector's norm, that
    the normalisation divides by.

    Returns (a (..., F, M) with a[..., 0] ~ 1, conf (..., F) in [0, 1])."""
    M = R_noise.shape[-1]
    tr_n = _trace(R_noise)
    Rl = R_noise + (load * tr_n + eps)[..., None, None] * torch.eye(
        M, dtype=R_noise.dtype, device=R_noise.device)
    if M == 2:
        A = torch.stack([solve_2x2_hermitian(Rl, R_tgt[..., :, 0]),
                         solve_2x2_hermitian(Rl, R_tgt[..., :, 1])], dim=-1)
        tr_a = A[..., 0, 0] + A[..., 1, 1]
        det_a = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        disc = csqrt_cut(tr_a * tr_a - 4.0 * det_a)
        lam_hi = torch.abs(0.5 * (tr_a + disc))
        lam_lo = torch.abs(0.5 * (tr_a - disc))
        hi = torch.maximum(lam_hi, lam_lo)
        lo = torch.minimum(lam_hi, lam_lo)
        conf = (hi - lo) / (hi + lo + eps)
        v = eig_principal_2x2(A)
    else:
        t_n = torch.clamp(tr_n / M, min=1e-30)
        # the target trace floored relative to the noise trace: a silent
        # masked bin's tiny R_tgt over an absolute floor would overflow
        t_t = torch.maximum(_trace(R_tgt) / M, 1e-12 * t_n)
        v = gev_principal_power((R_tgt / t_t[..., None, None]).to(Rl.dtype),
                                Rl / t_n[..., None, None])
        Rt_v = torch.einsum("...ij,...j->...i", R_tgt, v)
        Rl_v = torch.einsum("...ij,...j->...i", Rl, v)
        num = torch.real(torch.sum(torch.conj(v) * Rt_v, dim=-1))
        den = torch.real(torch.sum(torch.conj(v) * Rl_v, dim=-1))
        lam1 = torch.clamp(num / (den + eps), min=0.0)
        cols = torch.stack([solve_hermitian_small(Rl, R_tgt[..., :, i])[..., i]
                            for i in range(M)], dim=-1)
        tr_a = torch.clamp(torch.real(torch.sum(cols, dim=-1)), min=0.0)
        rest = torch.clamp(tr_a - lam1, min=0.0) / (M - 1)
        conf = (lam1 - rest) / (lam1 + rest + eps)
    a = torch.einsum("...ij,...j->...i", Rl, v)

    # reference-mic normalisation with a phase-preserving magnitude floor
    a0 = a[..., 0]
    mag = torch.abs(a0)
    phase = a0 / torch.clamp(mag, min=eps)
    nrm = torch.sqrt(torch.sum(torch.abs(a) ** 2, dim=-1))
    a0_safe = phase * torch.maximum(mag, ref_floor * torch.clamp(nrm, min=eps))
    return a / a0_safe[..., None], conf


def rtf_mvdr_beamform(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    freqs_hz: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    d_fallback: torch.Tensor | None = None,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
    conf_thresh: float = 0.7,
    mask_floor: float = 0.0,
    apply_post_filter: bool = True,
) -> torch.Tensor:
    """Masked MVDR steered by the estimated RTF. Y (..., M, F, T) ->
    (..., F, T), bins below ``hp_cutoff_hz`` zero.

    Bins with conf < ``conf_thresh`` take ``d_fallback`` ((F, M) or
    (..., F, M), the geometric steering) when it is given. Without
    ``target_mask`` the complement of ``noise_mask`` splits the covariances
    and no post-filter runs; with it, it is both the split and the
    post-filter (floored at ``mask_floor`` when that is positive), unless
    ``apply_post_filter`` is False."""
    tgt = 1.0 - noise_mask if target_mask is None else target_mask
    R_n = masked_covariance(Y, noise_mask)
    R_t = masked_covariance(Y, tgt)
    a, conf = rtf_from_covariances(R_t, R_n)
    d = a if d_fallback is None else torch.where((conf >= conf_thresh)[..., None], a, d_fallback)
    w = mvdr_weights(R_n, d, sigma=sigma)
    S = apply_weights(w, Y)
    keep = (freqs_hz >= hp_cutoff_hz)[:, None]
    S = torch.where(keep, S, torch.zeros((), dtype=S.dtype, device=S.device))
    if target_mask is not None and apply_post_filter:
        gain = torch.clamp(target_mask, min=mask_floor) if mask_floor > 0 else target_mask
        S = S * gain
    return S
