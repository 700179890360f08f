"""Sample-rate conversion (counterpart of azoom.dsp.resample).

  * :func:`resample_fft`: frequency-domain (scipy.signal.resample
    semantics), exact for band-limited signals, one rfft/irfft pair.
  * :func:`resample_poly`: Kaiser-windowed sinc polyphase, the reference's
    dilated strided convolution: zero-stuff by ``up``, filter, keep every
    ``down``-th sample.

Both run on the device of a tensor input (NumPy input goes to CUDA unless
``device="cpu"``), take their transforms in float64 and round once to
float32, so the card and the CPU give the same bits up to cuFFT's and
pocketfft's float64 rounding (no TF32 anywhere, no float32 accumulation
order that depends on the device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from azoom_torch.config import as_input

__all__ = ["resample_fft", "resample_poly", "upfirdn"]


def resample_fft(x, n_out: int, device=None) -> torch.Tensor:
    """Resample (..., n) -> float32 (..., n_out) in the frequency domain."""
    x = as_input(x, device)
    n_in = x.shape[-1]
    X = torch.fft.rfft(x.to(torch.float64), dim=-1)
    n_keep = min(n_in // 2 + 1, n_out // 2 + 1)
    Xr = X.new_zeros(x.shape[:-1] + (n_out // 2 + 1,))
    Xr[..., :n_keep] = X[..., :n_keep]
    # A real signal's DC and Nyquist bins are real: pocketfft's C2R drops
    # their imaginary parts, some cuFFT plans fold them in.
    Xr[..., 0].imag.zero_()
    if n_out % 2 == 0:
        Xr[..., n_out // 2].imag.zero_()
    return (torch.fft.irfft(Xr, n=n_out, dim=-1) * (n_out / n_in)).to(torch.float32)


def _design_lowpass(up: int, down: int, half_taps: int = 32) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at min(1/up, 1/down) of Nyquist."""
    cutoff = 1.0 / max(up, down)
    n = 2 * half_taps * max(up, down) + 1
    k = np.arange(n) - n // 2
    h = cutoff * np.sinc(cutoff * k) * np.kaiser(n, 8.0)
    return (h / h.sum() * up).astype(np.float32)


def upfirdn(x: torch.Tensor, h: np.ndarray, up: int, down: int, pad_l: int,
            n_out: int) -> torch.Tensor:
    """The dilated strided convolution y[..., j] = sum_k p[..., j*down + k] h[k]
    for j < n_out, where p is x zero-stuffed by ``up`` (x[i] at i*up) behind
    ``pad_l`` zeros and followed by zeros (XLA's ``conv_general_dilated`` with
    ``lhs_dilation=up``, ``window_strides=down``). One float64 FFT
    convolution with the reversed filter, rounded once to float32."""
    n, taps = x.shape[-1], len(h)
    n_eff = (n - 1) * up + 1
    xs = torch.zeros(x.shape[:-1] + (n_eff,), dtype=torch.float64, device=x.device)
    xs[..., ::up] = x
    hr = torch.from_numpy(np.ascontiguousarray(h[::-1], np.float64)).to(x.device)
    n_full = n_eff + taps - 1  # the linear convolution's support
    nfft = 1 << (n_full - 1).bit_length()
    c = torch.fft.irfft(torch.fft.rfft(xs, nfft) * torch.fft.rfft(hr, nfft), nfft)[..., :n_full]
    start = taps - 1 - pad_l  # y[j] = c[start + j*down], zero beyond the support
    need = start + (n_out - 1) * down + 1
    if need > n_full:
        c = torch.nn.functional.pad(c, (0, need - n_full))
    return c[..., start:need:down].to(torch.float32)


def resample_poly(x, up: int, down: int, device=None) -> torch.Tensor:
    """Polyphase rational resampling (..., n) -> float32 (..., ceil(n*up/down)).

    16 kHz -> 10 kHz (the STOI path) is up=5, down=8.
    """
    x = as_input(x, device)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.to(torch.float32)
    h = _design_lowpass(up, down)
    n = x.shape[-1]
    n_out = -(-n * up // down)
    pad = (len(h) - 1) // 2
    # Right padding sized so the strided conv emits AT LEAST n_out samples:
    # the symmetric (pad, pad) choice can come up one short for some
    # (n, up, down) (n=137815, up=20, down=17; and integer upsampling,
    # up=3/down=1, is short for every n).
    n_eff = (n - 1) * up + 1
    pad_r = max(pad, (n_out - 1) * down + len(h) - n_eff - pad)
    emitted = (n_eff + pad + pad_r - len(h)) // down + 1
    return upfirdn(x, h, up, down, pad, emitted)[..., :n_out]
