"""MVDR beamformer in closed form over the (freq, time) grid, complex64
(counterpart of azoom.beam.mvdr):

    w[f] = (R[f] + sigma I)^-1 d[f] / (d[f]^H (R[f]+sigma I)^-1 d[f])
    S_out[f, t] = w[f]^H Y[:, f, t]

This is also the plain version of the fused CUDA kernel
(azoom_torch.kernels.mvdr_kernel). Steering vectors d may be shared, (F, M),
or one set per stream, (..., F, M) matching Y's leading dims; the loading
sigma may be a scalar, per bin (F,), per stream (...,) or (..., 1), or both
(..., F) (:func:`loading_strides`). The JAX package computes the per-stream form by
vmapping the MVDR over streams (azoom/stream/server.py).
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import solve_2x2_hermitian

__all__ = ["mvdr_weights", "apply_weights", "mvdr_beamform", "masked_mvdr", "loading_strides"]


def loading_strides(shape, lead, F: int) -> tuple[int, int]:
    """Where a loading tensor of ``shape`` keeps stream b's loading of bin f,
    for an STFT with leading dims ``lead`` and F bins: the flat index
    ``b * bstride + f * fstride``, returned as (bstride, fstride). () is one
    loading for all; (F,) one per bin; ``lead + (1,)`` or ``lead`` one per
    stream; ``lead + (F,)`` one per stream and bin. When ``lead`` is (F,) a
    sigma of shape (F,) could mean either and is refused: pass (F, 1) for
    one per stream, or (F, F) for one per bin in every stream."""
    shape, lead = tuple(shape), tuple(lead)
    if shape == ():
        return 0, 0
    if shape == lead == (F,):
        raise ValueError(
            f"sigma of shape {shape} is ambiguous with {F} streams of {F} bins: pass "
            f"({F}, 1) for one loading per stream or ({F}, {F}) for one per bin")
    if shape == (F,):
        return 0, 1
    if shape in (lead, lead + (1,)):
        return 1, 0
    if shape == lead + (F,):
        return F, 1
    raise ValueError(
        f"sigma of shape {shape} fits neither (), ({F},), {lead}, {lead + (1,)} nor "
        f"{lead + (F,)}")


def _loading(sigma, R: torch.Tensor):
    """``sigma`` as a term broadcastable against (..., F, M, M): a Python
    scalar stays one; a tensor of shape (..., F) (per-bin or per-stream
    loading, which the fused kernel also takes) gains two trailing axes."""
    if isinstance(sigma, torch.Tensor):
        return sigma.to(device=R.device, dtype=R.real.dtype)[..., None, None]
    return sigma


def mvdr_weights(
    R_noise: torch.Tensor, d: torch.Tensor, sigma=1e-7, eps: float = 1e-10
) -> torch.Tensor:
    """MVDR weights (..., F, M) from noise covariance (..., F, M, M) and
    steering vectors (..., F, M). Only M = 2 is ported."""
    M = R_noise.shape[-1]
    if M != 2:
        raise NotImplementedError(
            "M > 2 MVDR needs the unrolled-Cholesky solve of "
            "azoom/beam/linalgmm.py, which is queued for a later slice of "
            "the port"
        )
    eye = torch.eye(M, dtype=R_noise.dtype, device=R_noise.device)
    R_loaded = R_noise + _loading(sigma, R_noise) * eye
    R_inv_d = solve_2x2_hermitian(R_loaded, d)
    denom = torch.sum(torch.conj(d) * R_inv_d, dim=-1, keepdim=True)
    return R_inv_d / (denom + eps)


def apply_weights(w: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """S[.., f, t] = w[.., f]^H Y[.., :, f, t]; w (..., F, M), Y (..., M, F, T)."""
    return torch.sum(torch.conj(w).transpose(-1, -2)[..., None] * Y, dim=-3)


def mvdr_beamform(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    sigma=1e-7,
    hp_cutoff_hz: float = 100.0,
) -> torch.Tensor:
    """Full masked-MVDR pass on an STFT block (..., M, F, T) -> (..., F, T);
    bins below ``hp_cutoff_hz`` are zero. ``d`` is (F, M) or (..., F, M);
    a tensor ``sigma`` is laid out as :func:`loading_strides` says."""
    if isinstance(sigma, torch.Tensor) and loading_strides(
            sigma.shape, Y.shape[:-3], Y.shape[-2]) == (1, 0):
        sigma = sigma.reshape(Y.shape[:-3] + (1,))  # per stream: the same loading at every bin
    R = masked_covariance(Y, noise_mask)
    w = mvdr_weights(R, d, sigma=sigma)
    S = apply_weights(w, Y)
    keep = (freqs_hz >= hp_cutoff_hz)[:, None]
    return torch.where(keep, S, torch.zeros((), dtype=S.dtype, device=S.device))


def masked_mvdr(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    sigma=1e-7,
    hp_cutoff_hz: float = 100.0,
    mask_floor: float = 0.0,
) -> torch.Tensor:
    """MVDR + optional spectral post-filter: multiply by the target mask,
    floored at ``mask_floor`` when that is positive."""
    S = mvdr_beamform(Y, noise_mask, d, freqs_hz, sigma, hp_cutoff_hz)
    if target_mask is not None:
        gain = torch.clamp(target_mask, min=mask_floor) if mask_floor > 0 else target_mask
        S = S * gain
    return S
