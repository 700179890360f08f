"""DUET-style spatial clustering masks (counterpart of azoom.masks.duet):
every time-frequency bin votes for a bearing from its inter-channel phase
(``bin_doa``), and a soft assignment around each source's bearing gives
per-source masks (``duet_masks``): separation masks, or a post-process that
cleans a learned mask."""

from __future__ import annotations

import math

import torch

__all__ = ["duet_masks", "bin_doa"]


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


def duet_masks(
    Y: torch.Tensor,
    source_angles_deg,
    mic_dist,
    fs: int,
    c: float = 343.0,
    width_deg: float = 15.0,
    invalid_value: float = 0.5,
) -> torch.Tensor:
    """Soft per-source masks by nearest-bearing assignment of an STFT Y
    (..., M, F, T) to the K bearings ``source_angles_deg`` (K,): a softmax
    over the sources of -0.5 ((theta - bearing) / width_deg)^2, float32
    (..., K, F, T) in [0, 1]; bins with no usable spatial cue (aliased, or
    |cos| > 1) take ``invalid_value`` (0.5: undecided)."""
    theta, valid = bin_doa(Y, mic_dist, fs, c)
    angles = torch.as_tensor(source_angles_deg, dtype=torch.float32, device=Y.device)
    diff = theta[..., None, :, :] - angles[:, None, None]  # (..., K, F, T)
    logits = -0.5 * (diff / width_deg) ** 2
    masks = torch.softmax(logits, dim=-3)
    return torch.where(valid[..., None, :, :], masks,
                       torch.full((), invalid_value, dtype=masks.dtype, device=masks.device))
