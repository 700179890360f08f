"""STOI (Short-Time Objective Intelligibility, Taal et al. 2010) in PyTorch
(counterpart of azoom.eval.stoi).

Algorithm (classic STOI, pystoi's conventions): resample to 10 kHz
(polyphase, kaiser(5) windowed sinc); 256-point Hann frames, hop 128,
512-point FFT; drop the frames more than 40 dB below the loudest clean frame
by compacting the rest (overlap-added back into a signal and re-framed); 15
one-third-octave band envelopes (150 Hz * 2^(k/3), nearest-bin edges);
length-30 segments; the degraded segment normalised and clipped at -15 dB
SDR; per-band per-segment correlation, averaged.

Static shapes, as the reference's: the active frames are compacted to the
front by a stable argsort and the rest zeroed, and a segment is scored only
while it lies inside the ``n_active`` frames that carry the compacted
signal. Leading batch dimensions are scored independently (the reference
gets them from ``jax.vmap``).

Precision: the resampling and the band spectra are taken in float64 and
rounded once to float32 (device-independent); the frame energies, the 40 dB
gate, the segment clip and the correlations are float32 in the reference's
order (norm, log10, compare), so a frame decides the gate as the
reference's does unless its energy lies within an ulp of the threshold.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch

from azoom_torch.config import as_input
from azoom_torch.dsp.resample import upfirdn

__all__ = ["stoi"]

FS_STOI = 10_000
FRAME = 256
HOP = 128
NFFT = 512
N_BANDS = 15
MIN_FREQ = 150.0
SEG = 30  # frames per segment (384 ms)
BETA_DB = -15.0
DYN_RANGE_DB = 40.0


def _third_octave_matrix() -> np.ndarray:
    """(N_BANDS, NFFT//2+1) binary band-membership matrix, with pystoi's
    nearest-FFT-bin band edges."""
    f = np.linspace(0, FS_STOI / 2, NFFT // 2 + 1)
    cf = MIN_FREQ * 2.0 ** (np.arange(N_BANDS) / 3.0)
    lo = cf / 2.0 ** (1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    k = np.arange(NFFT // 2 + 1)
    lo_idx = np.argmin((f[None, :] - lo[:, None]) ** 2, axis=1)
    hi_idx = np.argmin((f[None, :] - hi[:, None]) ** 2, axis=1)
    H = (k[None, :] >= lo_idx[:, None]) & (k[None, :] < hi_idx[:, None])
    return H.astype(np.float32)


_OCT = _third_octave_matrix()
_FRAME_WIN = np.hanning(FRAME + 2)[1:-1].astype(np.float32)


@functools.lru_cache(maxsize=8)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """Windowed-sinc anti-aliasing FIR for up/down polyphase resampling
    (scipy.signal.resample_poly's kaiser(beta=5) design)."""
    max_rate = max(up, down)
    half = 10 * max_rate
    t = np.arange(-half, half + 1)
    fc = 1.0 / max_rate
    h = fc * np.sinc(t * fc) * np.kaiser(2 * half + 1, 5.0) * up
    return h.astype(np.float32)


def _poly_resample(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """(..., n) -> (..., ((n - 1) * up) // down + 1): the reference's dilated
    strided convolution with symmetric (half, half) padding."""
    if up == down:
        return x
    h = _poly_filter(up, down)
    half = (len(h) - 1) // 2
    return upfirdn(x, h, up, down, half, ((x.shape[-1] - 1) * up) // down + 1)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., T, FRAME) Hann-windowed frames."""
    return x.unfold(-1, FRAME, HOP) * torch.from_numpy(_FRAME_WIN).to(x.device)


def _ola(fr: torch.Tensor) -> torch.Tensor:
    """50 % overlap-add of (..., T, FRAME) frames: each hop-block is one
    frame's second half plus the next frame's first half."""
    mid = fr[..., :-1, HOP:] + fr[..., 1:, :HOP]
    return torch.cat([fr[..., 0, :HOP], mid.flatten(-2), fr[..., -1, HOP:]], dim=-1)


def _band_envelopes(frames: torch.Tensor) -> torch.Tensor:
    """(..., T, FRAME) float32 frames -> (..., T, N_BANDS) band magnitudes:
    sqrt(sum over the band of |X|^2 + 1e-12), in float64, rounded once."""
    X = torch.fft.rfft(frames.to(torch.float64), n=NFFT, dim=-1).abs() ** 2
    H = torch.from_numpy(_OCT).to(device=frames.device, dtype=torch.float64)
    return torch.sqrt(X @ H.T + 1e-12).to(torch.float32)


def stoi(clean, degraded, fs: int = 16_000, device=None) -> torch.Tensor:
    """STOI score in (0, 1) of ``degraded`` against ``clean``, both (..., n)
    at sample rate ``fs``; returns float32 of shape (...,). Runs on the
    device of a tensor input (NumPy input goes to CUDA unless
    ``device="cpu"``)."""
    clean = as_input(clean, device).to(torch.float32)
    degraded = as_input(degraded, device).to(device=clean.device, dtype=torch.float32)
    g = gcd(FS_STOI, fs)
    up, down = FS_STOI // g, fs // g
    xf = _frames(_poly_resample(clean, up, down))  # (..., T, FRAME)
    yf = _frames(_poly_resample(degraded, up, down))
    T = xf.shape[-2]
    ar = torch.arange(T, device=xf.device)

    # Active frames of the clean signal: within 40 dB of the loudest.
    energy_db = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + 1e-10)
    active = energy_db > (energy_db.amax(dim=-1, keepdim=True) - DYN_RANGE_DB)
    n_active = active.sum(dim=-1, keepdim=True)  # (..., 1)

    # Compact the active frames to the front in their order, zero the rest,
    # overlap-add into compacted signals and frame them again; the first
    # n_active frames cover the compacted span.
    order = torch.sort((~active).to(torch.uint8), dim=-1, stable=True).indices
    valid = (ar < n_active).unsqueeze(-1).to(xf.dtype)
    idx = order.unsqueeze(-1).expand_as(xf)
    xf = _frames(_ola(torch.gather(xf, -2, idx) * valid))
    yf = _frames(_ola(torch.gather(yf, -2, idx) * valid))

    Xb = _band_envelopes(xf)  # (..., T, B)
    Yb = _band_envelopes(yf)
    Xs = Xb.unfold(-2, SEG, 1).transpose(-1, -2)  # (..., S, SEG, B)
    Ys = Yb.unfold(-2, SEG, 1).transpose(-1, -2)
    n_seg = Xs.shape[-3]
    # A segment is scored iff it lies wholly inside the active prefix.
    seg_ok = (torch.arange(n_seg, device=xf.device) + SEG <= n_active).to(torch.float32)

    alpha = torch.linalg.vector_norm(Xs, dim=-2, keepdim=True) / (
        torch.linalg.vector_norm(Ys, dim=-2, keepdim=True) + 1e-10)
    clip = 10.0 ** (-BETA_DB / 20.0)
    Yn = torch.minimum(alpha * Ys, Xs * (1.0 + clip))
    Xm = Xs - Xs.mean(dim=-2, keepdim=True)
    Ym = Yn - Yn.mean(dim=-2, keepdim=True)
    corr = (Xm * Ym).sum(dim=-2) / (
        torch.linalg.vector_norm(Xm, dim=-2) * torch.linalg.vector_norm(Ym, dim=-2) + 1e-10)
    return (corr.mean(dim=-1) * seg_ok).sum(dim=-1) / (seg_ok.sum(dim=-1) + 1e-10)
