"""Shoebox room acoustics: image-source RIRs (counterpart of azoom.sim.room).

The Allen-Berkley image-source model of a rectangular room, as the
reference computes it:

  * image positions ``x_img[d] = (-1)^q_d s_d + 2 n_d L_d`` for integer
    orders n in [-N, N]^3 and parities q in {0, 1}^3, kept where the
    reflection count ``|n - q| + |n|`` (summed over axes) is at most N;
  * per-image amplitude ``beta^refl / (4 pi max(dist, 1e-2))``;
  * each image's delta band-limited as a 16-tap Hann-windowed sinc at its
    fractional delay, scattered into the RIR;
  * Sabine's law inverted for the wall absorption.

Sizes: the lattice before truncation has (2N + 1)^3 x 8 points (238,328 at
the reference's N = 15); after it, 4,991 images remain at N = 15 (231 at
N = 5, 63 at N = 3). One (source, mic) RIR at N = 15 is ~80k taps, so every
(source, mic) pair is computed in one batched pass: the (S, M, I, 16) taps
and one scatter-add. The scatter-add is ``index_put_(accumulate=True)``: on
the CPU it adds in index order, as XLA's scatter does; on CUDA PyTorch runs
it as a sort by index and a sum per index in the original order, so two
runs on the card give the same bits.

The lattice is host NumPy, cached per order; the taps are float32 in the
reference's order (``dist`` as the square root of the summed squares, not a
norm routine): a one-ulp change of a delay near an integer moves a tap's
base sample and its fraction by one, which only the window's edge taps,
where the Hann weight is ~0, feel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from azoom_torch.config import as_input, resolve_device

__all__ = ["inverse_sabine", "shoebox_rir", "rir_matrix", "fft_convolve"]


def inverse_sabine(rt60: float, room_dim) -> float:
    """Uniform energy absorption from a target RT60 by Sabine's formula,
    ``a = 0.1611 V / (S RT60)``, capped at 0.9999."""
    L = np.asarray(room_dim, dtype=np.float64)
    V = float(np.prod(L))
    S = 2.0 * float(L[0] * L[1] + L[0] * L[2] + L[1] * L[2])
    return float(min(0.1611 * V / (S * rt60), 0.9999))


@functools.lru_cache(maxsize=None)
def _image_lattice(max_order: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer orders n (I, 3), parities q (I, 3) and reflection counts
    (I,) of the images with at most ``max_order`` reflections, in the
    reference's order (read-only: the arrays are cached)."""
    rng = np.arange(-max_order, max_order + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    q = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(-1, 3)
    n = np.repeat(n, 8, axis=0)
    q = np.tile(q, ((2 * max_order + 1) ** 3, 1))
    refl = np.abs(n - q).sum(-1) + np.abs(n).sum(-1)
    keep = refl <= max_order
    out = n[keep], q[keep], refl[keep]
    for a in out:
        a.setflags(write=False)
    return out


def _default_length(room_dim, max_order: int, fs: int, n_taps: int, c: float) -> int:
    """Taps that cover the longest image path of the truncated lattice."""
    diag = float(np.linalg.norm(np.asarray(room_dim, np.float64)))
    return int((2 * max_order + 1) * diag / c * fs) + n_taps + 1


def _rirs(sources: torch.Tensor, mics: torch.Tensor, room_dim, absorption: float,
          max_order: int, fs: int, rir_length: int, n_taps: int, c: float) -> torch.Tensor:
    """(S, M, rir_length) RIRs of sources (S, 3) at mics (M, 3), float32."""
    dev = sources.device
    n_np, q_np, refl_np = _image_lattice(max_order)
    n_lat = torch.tensor(n_np, dtype=torch.float32, device=dev)
    q_lat = torch.tensor(q_np, dtype=torch.float32, device=dev)
    refl = torch.tensor(refl_np, dtype=torch.float32, device=dev)
    dims = torch.as_tensor(room_dim, dtype=torch.float32, device=dev)
    beta = torch.tensor(max(1.0 - absorption, 0.0), dtype=torch.float32, device=dev).sqrt()

    img = (1.0 - 2.0 * q_lat) * sources[:, None, :] + 2.0 * n_lat * dims  # (S, I, 3)
    d = img[:, None] - mics[None, :, None, :]  # (S, M, I, 3)
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    amp = beta**refl / (4.0 * math.pi * dist.clamp(min=1e-2))
    # Divisions by device tensors: CUDA turns division by a host scalar into
    # a product with its reciprocal, which can flip floor(delay).
    delay = dist / torch.tensor(c, dtype=torch.float32, device=dev) * fs

    k = torch.arange(n_taps, dtype=torch.float32, device=dev) - (n_taps // 2)
    base = torch.floor(delay).to(torch.int32)
    frac = delay - base
    t = k - frac[..., None]  # (S, M, I, K)
    win = 0.5 + 0.5 * torch.cos(2.0 * math.pi * t / n_taps)  # Hann taper
    taps = torch.sinc(t) * win.clamp(min=0.0) * amp[..., None]
    idx = base[..., None] + k.to(torch.int32)
    valid = (idx >= 0) & (idx < rir_length)
    idx = idx.clamp(0, rir_length - 1).long()
    S, M = d.shape[:2]
    row = torch.arange(S * M, device=dev).reshape(S, M, 1, 1) * rir_length
    rir = torch.zeros(S * M * rir_length, dtype=torch.float32, device=dev)
    rir.index_put_(((idx + row).reshape(-1),), torch.where(valid, taps, 0.0).reshape(-1),
                   accumulate=True)
    return rir.reshape(S, M, rir_length)


def _device(x, device) -> torch.device:
    """A tensor's own device unless ``device`` is given; else resolve_device."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.device
    return resolve_device(device)


def shoebox_rir(source, mic, room_dim, absorption: float, max_order: int = 15,
                fs: int = 16_000, rir_length: int | None = None, n_taps: int = 16,
                c: float = 343.0, device=None) -> torch.Tensor:
    """The RIR (rir_length,) float32 from ``source`` to ``mic`` ((3,) meters)
    in a shoebox room with wall absorption ``absorption`` (from
    :func:`inverse_sabine`); ``max_order`` 0 is the direct path alone;
    ``rir_length`` defaults to the longest image path."""
    dev = _device(source, device)
    source = torch.as_tensor(source, dtype=torch.float32, device=dev).reshape(1, 3)
    return rir_matrix(source, mic, room_dim, absorption, max_order, fs, rir_length, n_taps,
                      c)[0, 0]


def rir_matrix(sources, mics, room_dim, absorption: float, max_order: int = 15,
               fs: int = 16_000, rir_length: int | None = None, n_taps: int = 16,
               c: float = 343.0, device=None) -> torch.Tensor:
    """RIRs of every (source, mic) pair, (S, M, rir_length) float32, in one
    batched pass (on CUDA unless ``device`` names another device, or on the
    device of a tensor ``sources``)."""
    dev = _device(sources, device)
    sources = torch.as_tensor(sources, dtype=torch.float32, device=dev).reshape(-1, 3)
    mics = torch.as_tensor(mics, dtype=torch.float32, device=dev).reshape(-1, 3)
    if rir_length is None:
        rir_length = _default_length(room_dim, max_order, fs, n_taps, c)
    return _rirs(sources, mics, room_dim, absorption, max_order, fs, int(rir_length), n_taps, c)


def fft_convolve(x, h, out_length: int, device=None) -> torch.Tensor:
    """Linear convolution through the FFT, cropped to ``out_length`` (the
    ``scipy.signal.fftconvolve(mode='full')[:n]`` idiom); broadcasts over
    leading dims of ``x`` and ``h``. float32 (no matmul, so no TF32)."""
    x = as_input(x, device)
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    H = torch.fft.rfft(h, n=nfft, dim=-1)
    return torch.fft.irfft(X * H, n=nfft, dim=-1)[..., :out_length]
