"""Input features for learned mask estimation, channels-last (counterpart of
azoom.masks.features).

``physics_aware_features``: [log|Y0|, sin(IPD), cos(IPD), freq_map]. The
``ipd_scale`` argument is geometry adaptation: the IPD at spacing d is
linear in d, so a net trained at spacing d_train serves another array by
scaling the measured IPD by d_train / d_actual.
"""

from __future__ import annotations

import torch

__all__ = ["physics_aware_features"]

_EPS = 1e-7


def _unit_scale(ipd_scale) -> bool:
    return isinstance(ipd_scale, (int, float)) and float(ipd_scale) == 1.0


def _cross_spectrum(Y: torch.Tensor, pair_mode: str) -> torch.Tensor:
    """IPD cross-spectrum of (..., M, F, T). ``pair_mode``: 'mean' averages
    all adjacent pairs (uniform linear arrays only); 'first' takes the first
    pair alone (required for explicit, non-uniform geometries)."""
    if pair_mode == "first":
        return Y[..., 0, :, :] * torch.conj(Y[..., 1, :, :])
    if pair_mode != "mean":
        raise ValueError(f"pair_mode must be 'mean' or 'first', got {pair_mode!r}")
    return torch.mean(Y[..., :-1, :, :] * torch.conj(Y[..., 1:, :, :]), dim=-3)


def physics_aware_features(
    Y: torch.Tensor, ipd_scale=1.0, pair_mode: str = "mean"
) -> torch.Tensor:
    """STFT (..., M, F, T) -> float32 features (..., F, T, 4):
    [log|Y0|, sin(ipd_scale*IPD), cos(ipd_scale*IPD), freq_map].

    Computed in float64 and rounded once, so the features have the same
    bits on the CPU and on CUDA: the int8 mask net would turn a one-ulp
    difference into a flipped activation code."""
    Y = Y.to(torch.complex128)
    logmag = torch.log(torch.abs(Y[..., 0, :, :]) + _EPS)
    cross = _cross_spectrum(Y, pair_mode)
    if _unit_scale(ipd_scale):
        # sin/cos of the IPD straight from the unit cross-spectrum.
        mag = torch.abs(cross) + 1e-12
        sin_ipd = cross.imag / mag
        cos_ipd = cross.real / mag
    else:
        ipd = torch.angle(cross + 1e-20) * ipd_scale
        sin_ipd = torch.sin(ipd)
        cos_ipd = torch.cos(ipd)
    F = Y.shape[-2]
    fmap = torch.linspace(0.0, 1.0, F, dtype=torch.float64, device=Y.device)
    fmap = fmap[:, None].expand(logmag.shape)
    return torch.stack([logmag, sin_ipd, cos_ipd, fmap], dim=-1).to(torch.float32)
