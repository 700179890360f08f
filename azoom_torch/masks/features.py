"""Input features for learned mask estimation, channels-last (counterpart of
azoom.masks.features).

``logmag_ipd_features``: [log|Y0|, IPD], the 2-channel features of the
FreqPreservingUNet nets. ``physics_aware_features``: [log|Y0|, sin(IPD),
cos(IPD), freq_map]. The ``ipd_scale`` argument is geometry adaptation: the
IPD at spacing d is linear in d, so a net trained at spacing d_train serves
another array by scaling the measured IPD by d_train / d_actual.
"""

from __future__ import annotations

import math

import torch

__all__ = ["logmag_ipd_features", "physics_aware_features"]

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


def logmag_ipd_features(
    Y: torch.Tensor, ipd_scale=1.0, pair_mode: str = "mean"
) -> torch.Tensor:
    """STFT (..., M, F, T) -> float32 features (..., F, T, 2):
    [log|Y0|, IPD * ipd_scale].

    At M == 2 with unit scale the IPD is the raw angle difference
    angle(Y0) - angle(Y1), range (-2 pi, 2 pi), the training convention of
    every bundled 2-channel net. Otherwise (geometry adaptation, or M > 2)
    it is the principal-value angle of the cross-spectrum (``pair_mode`` as
    :func:`physics_aware_features`), scaled and re-wrapped to [-pi, pi).

    The log-magnitude is taken in float64 and rounded once, as the physics
    features. The IPD keeps the reference's float32 roundings instead,
    because its value is defined by them: each angle is rounded to float32
    before the raw difference is taken in float32 (a float64 difference
    rounded once is another value, and a one-ulp stem difference flips int8
    codes), and under adaptation the float32 angle is scaled, shifted and
    wrapped in float32 as ``jnp.mod`` does."""
    Y64 = Y.to(torch.complex128)
    logmag = torch.log(torch.abs(Y64[..., 0, :, :]) + _EPS).to(torch.float32)
    unit = _unit_scale(ipd_scale)
    if Y.shape[-3] == 2 and unit:
        ipd = _angle32(Y64[..., 0, :, :]) - _angle32(Y64[..., 1, :, :])
    else:
        cross = _cross_spectrum(Y64, pair_mode).to(torch.complex64)
        ipd = _angle32(cross + 1e-20)
        if not unit:
            f32 = dict(dtype=torch.float32, device=ipd.device)
            pi, two_pi = torch.tensor(math.pi, **f32), torch.tensor(2.0 * math.pi, **f32)
            v = ipd * torch.as_tensor(ipd_scale, **f32) + pi
            # jnp.mod: the exact float32 remainder, moved into [0, 2 pi).
            r = torch.fmod(v, two_pi)
            ipd = torch.where(r < 0, r + two_pi, r) - pi
    return torch.stack([logmag, ipd], dim=-1)


def _angle32(z: torch.Tensor) -> torch.Tensor:
    """angle(z) correctly rounded to float32: taken in float64 of the exact
    components, so the CPU and CUDA give the same bits."""
    return torch.angle(z.to(torch.complex128)).to(torch.float32)


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
