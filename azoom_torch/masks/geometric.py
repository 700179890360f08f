"""Blind geometric masks and the visual field-of-view covariance gate
(counterpart of azoom.masks.geometric: ``ipd``, ``hard_geometric_noise_mask``,
``ipd_deviation_noise_mask``, ``fov_noise_gate``, ``apply_fov_gate``).

Transcendental steps (angles, arccos, sigmoid) run in float64 and are
rounded once, so the CPU and CUDA give the same bits.
"""

from __future__ import annotations

import math

import torch

from azoom_torch.dsp.delays import positions_2d
from azoom_torch.masks.duet import bin_doa

__all__ = [
    "ipd", "hard_geometric_noise_mask", "ipd_deviation_noise_mask", "fov_noise_gate",
    "apply_fov_gate",
]


def ipd(Y: torch.Tensor, pair_mode: str = "mean") -> torch.Tensor:
    """Inter-channel phase difference of an STFT Y (..., M, F, T) ->
    float32 (..., F, T). M = 2: the raw angle difference angle(Y0) -
    angle(Y1) in (-2 pi, 2 pi). M > 2: the principal-value phase of the
    cross-spectrum averaged over adjacent pairs ('mean') or of the first
    pair ('first', for explicit non-uniform geometries)."""
    return _ipd64(Y, pair_mode).to(torch.float32)


def _ipd64(Y: torch.Tensor, pair_mode: str) -> torch.Tensor:
    Y = Y.to(torch.complex128)
    if Y.shape[-3] == 2:
        out = torch.angle(Y[..., 0, :, :]) - torch.angle(Y[..., 1, :, :])
    else:
        if pair_mode == "first":
            cross = Y[..., 0, :, :] * torch.conj(Y[..., 1, :, :])
        else:
            cross = torch.mean(Y[..., :-1, :, :] * torch.conj(Y[..., 1:, :, :]), dim=-3)
        out = torch.angle(cross + 1e-20)
    return out


def hard_geometric_noise_mask(Y: torch.Tensor, threshold: float = 0.0,
                              floor: float = 0.01) -> torch.Tensor:
    """Hard IPD noise mask: 1 where |IPD| > threshold, else ``floor``
    (float32). With a broadside target the expected IPD is zero, so any
    phase deviation marks interference."""
    one = torch.ones((), dtype=torch.float32, device=Y.device)
    return torch.where(torch.abs(ipd(Y)) > threshold, one, floor * one)


def ipd_deviation_noise_mask(
    Y: torch.Tensor, expected_ipd: torch.Tensor, width: float = 0.5, pair_mode: str = "mean"
) -> torch.Tensor:
    """Soft geometric noise mask, float32 (..., F, T): the IPD's wrapped
    distance from an expected per-bin IPD (..., F) (e.g. of a steered target
    off broadside), |dev| / (width pi) clipped to [0, 1]. An ``expected_ipd``
    from the first pair's delays on an explicit non-uniform geometry needs
    ``pair_mode='first'``."""
    exp64 = torch.as_tensor(expected_ipd, device=Y.device).to(torch.float64)
    diff = _ipd64(Y, pair_mode) - exp64[..., :, None]
    dev = torch.remainder(diff + math.pi, 2.0 * math.pi) - math.pi
    return torch.clamp(torch.abs(dev) / (width * math.pi), 0.0, 1.0).to(torch.float32)


def fov_noise_gate(
    Y: torch.Tensor,
    center_deg,
    fov_deg,
    mic_dist: float,
    fs: int,
    c: float = 343.0,
    softness_deg: float = 10.0,
    positions: torch.Tensor | None = None,
):
    """Visual-guided covariance gate: per-bin DOAs scored against the field
    of view [center - fov/2, center + fov/2].

    Returns float32 ``gate`` (1 = confidently outside the FOV: enters the
    noise covariance), float32 ``protect`` (a cone of min(fov/2, 15) deg
    around the look direction: kept out of the noise covariance) and bool
    ``valid`` (bins with a usable spatial cue), all (..., F, T).

    With explicit ``positions`` the first pair's IPD measures the angle psi
    between the DOA and the pair's baseline (orientation phi); the FOV is
    scored against the closer of phi +/- psi on the circle.
    """
    dev64 = dict(dtype=torch.float64, device=Y.device)
    center = torch.as_tensor(center_deg, **dev64)
    fov = torch.as_tensor(fov_deg, **dev64)
    if positions is not None:
        p = positions_2d(2, mic_dist, positions, Y.device).to(torch.float64)
        dp = p[0] - p[1]
        eff_dist = torch.sqrt(torch.sum(dp**2)) + 1e-9
        phi = torch.rad2deg(torch.atan2(dp[1], dp[0]))
        psi, valid = bin_doa(Y[..., :2, :, :], eff_dist, fs, c)
        psi = psi.to(torch.float64)

        def circ(a):
            return torch.abs(torch.remainder(a + 180.0, 360.0) - 180.0)

        dev = torch.minimum(circ(phi + psi - center), circ(phi - psi - center))
    else:
        theta, valid = bin_doa(Y, mic_dist, fs, c)
        dev = torch.abs(theta.to(torch.float64) - center)
    gate = torch.sigmoid((dev - 0.5 * fov) / softness_deg)
    cone = torch.clamp(0.5 * fov, max=15.0)
    protect = torch.sigmoid((cone - dev) / softness_deg)
    return gate.to(torch.float32), protect.to(torch.float32), valid


def apply_fov_gate(noise_mask: torch.Tensor, gate: torch.Tensor, protect: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Combine a mask-net noise mask with the visual gate: on valid-cue
    bins clip(max(noise, gate) - protect, 0, 1), elsewhere the net's mask."""
    gated = torch.clamp(torch.maximum(noise_mask, gate) - protect, 0.0, 1.0)
    return torch.where(valid, gated, noise_mask)
