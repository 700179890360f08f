"""Per-bin DOA from the inter-channel phase (counterpart of
azoom.masks.duet.bin_doa; ``duet_masks`` is not ported yet)."""

from __future__ import annotations

import math

import torch

__all__ = ["bin_doa"]


def bin_doa(Y: torch.Tensor, mic_dist, fs: int, c: float = 343.0):
    """Per-TF-bin DOA estimate of an STFT Y (..., M, F, T).

    Returns (theta_deg float32 (..., F, T), valid bool (..., F, T)); valid
    flags bins below the spatial-aliasing limit with a physical |cos| <= 1.
    The cross-spectrum of adjacent pairs is averaged (the mean of one pair
    at M = 2). The bin frequencies are float32, as the reference's; the
    arithmetic runs in float64 and theta is rounded once, so the CPU and
    CUDA give the same bits.
    """
    F = Y.shape[-2]
    n_fft = 2 * (F - 1)
    freqs = (torch.arange(F, dtype=torch.float32, device=Y.device) * (fs / n_fft)).to(torch.float64)
    Y = Y.to(torch.complex128)
    cross = torch.mean(Y[..., :-1, :, :] * torch.conj(Y[..., 1:, :, :]), dim=-3)
    ipd = torch.angle(cross + 1e-20)
    d = torch.as_tensor(mic_dist, dtype=torch.float64, device=Y.device)
    cos_t = -ipd * c / (2.0 * math.pi * torch.clamp(freqs, min=1.0)[:, None] * d)
    alias_ok = (freqs[:, None] <= c / (2.0 * d)) & (freqs[:, None] > 0)
    valid = (torch.abs(cos_t) <= 1.0) & alias_ok
    theta = torch.rad2deg(torch.arccos(torch.clamp(cos_t, -1.0, 1.0)))
    return theta.to(torch.float32), valid
