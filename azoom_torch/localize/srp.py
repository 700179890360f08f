"""Blind direction-of-arrival maps (counterpart of azoom.localize.srp):
steered response power, GCC-PHAT and the per-bin IPD angle histogram, each
over a 0..180 deg azimuth grid, and their FOV-restricted peaks.

The histogram is what the server's trackers and the autosteer pipeline
read. Its soft binning votes every time-frequency bin onto every angle; at
the server's batch (128 streams, 65 frames) that is a (S, F, T, 181) product
of ~3 GB, so the votes are summed in blocks of bins, and only over the bins
of the analysis band (the others carry zero weight), which the host works
out from the shapes. Angles and weights are computed in float64 and rounded
once; the votes and their sums are float32, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from azoom_torch.dsp.delays import steering_matrix

__all__ = [
    "srp_map", "srp_localize", "gcc_phat_map", "gcc_phat_localize", "ipd_angle_histogram",
    "ipd_histogram_localize",
]

# Elements of one block of histogram votes (float32: 128 MB).
_VOTE_BLOCK = 1 << 25


def _angle_grid(n_angles: int, device) -> torch.Tensor:
    return torch.linspace(0.0, 180.0, n_angles, dtype=torch.float32, device=device)


def _band_bins(F: int, fs: float, lo: float, hi: float) -> tuple[int, int]:
    """[first, last + 1) of the one-sided bins of an STFT with F bins whose
    float32 frequency is in [lo, hi], as the reference compares them; (0, 0)
    when there is none. On the host: nothing waits for the device."""
    freqs = np.arange(F, dtype=np.float32) * np.float32(fs / (2 * (F - 1)))
    idx = np.flatnonzero((freqs >= np.float32(lo)) & (freqs <= np.float32(hi)))
    return (int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, 0)


def srp_map(
    Y: torch.Tensor,
    freqs_hz: torch.Tensor,
    mic_dist: float,
    band_hz: tuple[float, float] = (200.0, 4000.0),
    n_angles: int = 181,
    c: float = 343.0,
    phat: bool = False,
    positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steered response power over an azimuth grid: a delay-and-sum beam at
    each angle, its power summed over the band and the frames.

    Y complex (..., M, F, T); ``phat`` magnitude-whitens Y first;
    ``positions`` gives explicit mic coordinates. Returns (angles_deg (A,),
    power float32 (..., A)), linear.
    """
    angles = _angle_grid(n_angles, Y.device)
    M = Y.shape[-3]
    freqs_hz = freqs_hz.to(Y.device)
    band = ((freqs_hz >= band_hz[0]) & (freqs_hz <= band_hz[1])).to(torch.float64)
    Y = Y.to(torch.complex128)
    if phat:
        Y = Y / (torch.abs(Y) + 1e-10)
    if positions is not None:
        positions = positions.to(Y.device)
    D = steering_matrix(freqs_hz, angles, mic_dist, c, M, positions=positions)
    S = torch.einsum("afm,...mft->...aft", torch.conj(D).to(torch.complex128), Y) / M
    power = torch.sum((S.real ** 2 + S.imag ** 2) * band[:, None], dim=(-2, -1))
    return angles, power.to(torch.float32)


def srp_localize(Y, freqs_hz, mic_dist, positions=None, **kwargs) -> torch.Tensor:
    """Peak of the SRP map: the estimated azimuth in degrees (...,)."""
    angles, power = srp_map(Y, freqs_hz, mic_dist, positions=positions, **kwargs)
    return angles[torch.argmax(power, dim=-1)]


def gcc_phat_map(
    Y: torch.Tensor,
    mic_dist: float,
    fs: int,
    c: float = 343.0,
    n_angles: int = 181,
    band_hz: tuple[float, float] = (200.0, 4000.0),
) -> tuple[torch.Tensor, torch.Tensor]:
    """GCC-PHAT angular spectrum of a 2-mic STFT (..., 2, F, T): the
    phase-whitened, frame-averaged cross-spectrum steered to each angle's
    TDOA d cos(theta) / c. Returns (angles_deg (A,), gcc float32 (..., A))."""
    F = Y.shape[-2]
    n_fft = 2 * (F - 1)
    freqs = torch.arange(F, dtype=torch.float32, device=Y.device) * (fs / n_fft)
    band = ((freqs >= band_hz[0]) & (freqs <= band_hz[1])).to(torch.float64)
    Y = Y.to(torch.complex128)
    cross = Y[..., 0, :, :] * torch.conj(Y[..., 1, :, :])
    cross = cross / (torch.abs(cross) + 1e-10)
    cross = torch.mean(cross, dim=-1) * band  # (..., F)
    angles = _angle_grid(n_angles, Y.device)
    tau = mic_dist * torch.cos(torch.deg2rad(angles.to(torch.float64))) / c
    phase = 2.0 * math.pi * freqs.to(torch.float64)[None, :] * tau[:, None]  # (A, F)
    gcc = torch.einsum("...f,af->...a", cross, torch.complex(torch.cos(phase), torch.sin(phase)))
    return angles, gcc.real.to(torch.float32)


def ipd_angle_histogram(
    Y: torch.Tensor,
    mic_dist: float,
    fs: int,
    c: float = 343.0,
    n_angles: int = 181,
    band_hz: tuple[float, float | None] = (200.0, None),
    kernel_deg: float = 5.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparsity-based localization: each time-frequency bin below the
    spatial-aliasing frequency votes for the azimuth its IPD implies,
    cos(theta) = -IPD c / (2 pi f d), weighted by |Y0|^2 and soft-binned by
    a Gaussian of ``kernel_deg``; one mode per talker.

    Y complex (..., M, F, T), M >= 2 (adjacent pairs' cross-spectra are
    averaged); ``band_hz`` (lo, hi), hi=None caps at c / (2 mic_dist).
    Returns (angles_deg (A,), histogram float32 (..., A)).
    """
    F = Y.shape[-2]
    n_fft = 2 * (F - 1)
    freqs = torch.arange(F, dtype=torch.float32, device=Y.device) * (fs / n_fft)
    hi = band_hz[1] if band_hz[1] is not None else c / (2.0 * mic_dist)
    f0, f1 = _band_bins(F, fs, band_hz[0], hi)
    angles = _angle_grid(n_angles, Y.device)
    lead, T = Y.shape[:-3], Y.shape[-1]
    hist = torch.zeros(lead + (n_angles,), dtype=torch.float32, device=Y.device)
    if f1 == f0:
        return angles, hist
    Yb = Y[..., f0:f1, :].to(torch.complex128)
    cross = torch.mean(Yb[..., :-1, :, :] * torch.conj(Yb[..., 1:, :, :]), dim=-3)
    ipd = torch.angle(cross + 1e-20)  # (..., Fb, T)
    fb = torch.clamp(freqs[f0:f1].to(torch.float64), min=1.0)[:, None]
    cos_t = -ipd * c / (2.0 * math.pi * fb * mic_dist)
    w = torch.where(torch.abs(cos_t) <= 1.0, torch.abs(Yb[..., 0, :, :]) ** 2, 0.0)
    theta = torch.rad2deg(torch.arccos(torch.clamp(cos_t, -1.0, 1.0))).to(torch.float32)
    w = w.to(torch.float32)
    # Soft binning, summed over (bin, frame) in blocks of bins:
    # hist[..., a] = sum w * exp(-0.5 ((theta - a) / k)^2).
    n_lead = math.prod(lead)
    theta = theta.reshape(n_lead, f1 - f0, T)
    w = w.reshape(n_lead, 1, (f1 - f0) * T)
    flat = hist.reshape(n_lead, n_angles)
    step = max(1, _VOTE_BLOCK // max(1, n_lead * T * n_angles))
    for s in range(0, f1 - f0, step):
        v = theta[:, s:s + step, :, None] - angles  # (S, blk, T, A)
        v.div_(kernel_deg).square_().mul_(-0.5).exp_()
        blk = v.shape[1] * T
        flat += torch.bmm(w[:, :, s * T:s * T + blk], v.reshape(n_lead, blk, n_angles))[:, 0]
    return angles, hist


def _fov_argmax(angles, score, fov_center_deg, fov_width_deg) -> torch.Tensor:
    if fov_center_deg is not None:
        in_fov = torch.abs(angles - fov_center_deg) <= fov_width_deg / 2.0
        score = torch.where(in_fov, score, -math.inf)
    return angles[torch.argmax(score, dim=-1)]


def ipd_histogram_localize(Y, mic_dist, fs, fov_center_deg=None, fov_width_deg=180.0,
                           **kwargs) -> torch.Tensor:
    """Dominant azimuth of the IPD histogram, optionally restricted to the
    visual zoom's field of view."""
    angles, hist = ipd_angle_histogram(Y, mic_dist, fs, **kwargs)
    return _fov_argmax(angles, hist, fov_center_deg, fov_width_deg)


def gcc_phat_localize(Y, mic_dist, fs, fov_center_deg=None, fov_width_deg=180.0,
                      **kwargs) -> torch.Tensor:
    """Dominant azimuth by GCC-PHAT, optionally restricted to the field of
    view."""
    angles, gcc = gcc_phat_map(Y, mic_dist, fs, **kwargs)
    return _fov_argmax(angles, gcc, fov_center_deg, fov_width_deg)
