"""Harmonic-regeneration post-filter, HRNR (counterpart of
azoom.beam.postfilter; C. Plapous, C. Marro, P. Scalart, "Speech
enhancement exploiting the harmonic regeneration", IEEE TASLP 2006).

A stage-1 post-filter multiplies the beamformed spectrum by a floored mask;
a target harmonic the net scored as interference is then punched out of the
harmonic comb. A memoryless nonlinearity of the stage-1 time signal
regenerates energy at every multiple of its f0, so:

    S1  = S_bf * g1,  s1 = istft(S1)
    S_h = stft(max(s1, 0)), rescaled per frame to S1's energy
    xi  = (g1 |S1|^2 + (1 - g1) |S_h|^2) / N,  G2 = xi / (1 + xi)
    out = S_bf * max(g1, G2)

with N a minimum-statistics noise PSD (a low time-quantile of |S_bf|^2,
bias-corrected under the exponential power model). The final gain only
re-opens bins: it never falls below the stage-1 gain.

Plain PyTorch on the device of its input: no Pallas kernel stands behind
it. The quantile sorts along time and interpolates linearly at q (T - 1),
as ``jnp.quantile`` does (``torch.quantile`` refuses inputs above 2^24
elements); the extra iSTFT -> STFT round trip goes through
``azoom_torch.dsp.stft`` (float64 inside, rounded once).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from azoom_torch.dsp.stft import istft, stft

__all__ = ["harmonic_regeneration", "min_stats_noise_psd"]


def _quantile_last(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of float32 x along its last axis, kept as (..., 1):
    linear interpolation between the sorted values at floor and ceil of
    q (n - 1), with the position and weights in float32 as jnp.quantile
    takes them."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    return s[..., lo:lo + 1] * float(w_lo) + s[..., hi:hi + 1] * float(w_hi)


def min_stats_noise_psd(S: torch.Tensor, quantile: float = 0.2,
                        eps: float = 1e-12) -> torch.Tensor:
    """Per-bin stationary-noise PSD (..., F, 1) of a complex spectrum
    (..., F, T): the ``quantile`` of the power over time divided by
    -ln(1 - quantile) (the mean under the exponential power model)."""
    q = _quantile_last(torch.abs(S) ** 2, quantile)
    return q / float(np.float32(-math.log1p(-quantile)) + np.float32(eps))


def harmonic_regeneration(
    S_bf: torch.Tensor,
    g1: torch.Tensor,
    n_fft: int,
    hop: int,
    length: int,
    noise_psd: torch.Tensor | None = None,
    noise_quantile: float = 0.2,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Stage-2 HRNR gain over a beamformed spectrum.

    S_bf complex64 (..., F, T), the beamformer's output before any spectral
    post-filter; g1 float32 (..., F, T), the stage-1 gain in [0, 1];
    ``n_fft`` / ``hop`` the STFT S_bf came from and ``length`` its signal's
    sample count (the round trip must give back T frames); ``noise_psd``
    (..., F, 1) overrides the minimum-statistics tracker of
    ``noise_quantile``. Returns S_bf * max(g1, G2), complex64 (..., F, T).
    """
    S1 = S_bf * g1
    p1 = torch.abs(S1) ** 2
    if noise_psd is None:
        noise_psd = min_stats_noise_psd(S_bf, noise_quantile, eps)
    # Half-wave rectification regenerates the stage-1 signal's harmonics;
    # the per-frame rescale keeps them on the stage-1 energy scale.
    s1 = istft(S1, n_fft, hop, length=length)
    S_h = stft(torch.clamp(s1, min=0.0), n_fft, hop)
    ph = torch.abs(S_h) ** 2
    e1 = torch.sum(p1, dim=-2, keepdim=True)
    eh = torch.sum(ph, dim=-2, keepdim=True)
    p_h = ph * (e1 / (eh + eps))
    xi = (g1 * p1 + (1.0 - g1) * p_h) / (noise_psd + eps)
    g2 = xi / (1.0 + xi)
    return S_bf * torch.maximum(g1, g2)
