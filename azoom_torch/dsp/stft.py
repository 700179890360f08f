"""STFT / iSTFT with scipy.signal.stft conventions, in PyTorch.

The conventions are those of azoom.dsp.stft, for numerical parity:

  * periodic Hann window of length ``n_fft``
  * ``boundary='zeros'``: the signal is extended by ``n_fft // 2`` zeros on
    both ends
  * ``padded=True``: the tail is zero-padded to a whole number of hops
  * one-sided rfft, spectrum scaling ``1 / win.sum()``
  * iSTFT: windowed overlap-add normalised by the window-square OLA sum

The transform is framing plus ``torch.fft.rfft``/``irfft``; ``torch.stft``
is not used because its defaults (centring, padding mode, scaling) differ.
Everything runs on the device of the input. Both transforms are taken in
float64 and rounded once to float32, so they give the same bits on the CPU
and on CUDA (pocketfft and cuFFT round differently in float32, and cuFFT's
plans differ with the batch size); the int8 mask net downstream turns
one-ulp feature differences into flipped activation codes, so the port
keeps its front end device-independent.
"""

from __future__ import annotations

import torch

from azoom_torch.dsp.windows import hann

__all__ = ["stft", "istft", "stft_frame_count", "rfft_freqs"]

_PRECISIONS = ("exact", "fast")


def stft_frame_count(n_samples: int, n_fft: int, hop: int) -> int:
    """Number of STFT frames scipy would produce (boundary + padded)."""
    ext = n_samples + 2 * (n_fft // 2)
    n_add = (-(ext - n_fft)) % hop
    return (ext + n_add - n_fft) // hop + 1


def rfft_freqs(n_fft: int, fs: float, device=None) -> torch.Tensor:
    """Center frequency (Hz) of each one-sided FFT bin, float32."""
    return torch.arange(n_fft // 2 + 1, device=device, dtype=torch.float32) * (
        fs / n_fft
    )


def _check_precision(precision: str) -> None:
    # Accepted for signature parity with azoom.dsp.stft, where it picks the
    # TPU's matmul-DFT precision; on the CPU and CUDA it selects nothing.
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}"
        )


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA frames (..., n_frames, n_fft) into (..., (n_frames-1)*hop + n_fft)."""
    *lead, n_frames, n_fft = frames.shape
    out_len = (n_frames - 1) * hop + n_fft
    if n_fft % hop == 0:
        # Each frame is r = n_fft/hop hop-sized rows; row k of frame i lands
        # on output row i + k, so the OLA is r shifted slice-adds.
        r = n_fft // hop
        n_rows = n_frames - 1 + r
        out = frames.new_zeros((*lead, n_rows, hop))
        for k in range(r):
            out[..., k:k + n_frames, :] += frames[..., k * hop:(k + 1) * hop]
        return out.reshape(*lead, n_rows * hop)[..., :out_len]
    starts = torch.arange(n_frames, device=frames.device) * hop
    idx = (starts[:, None] + torch.arange(n_fft, device=frames.device)).reshape(-1)
    out = frames.new_zeros((*lead, out_len))
    return out.index_add_(-1, idx, frames.reshape(*lead, n_frames * n_fft))


def stft(
    x: torch.Tensor, n_fft: int = 1024, hop: int = 512, precision: str = "exact"
) -> torch.Tensor:
    """One-sided STFT of x (..., samples) -> complex64 (..., n_freqs, n_frames).

    Matches ``scipy.signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop)[2]``.
    """
    _check_precision(precision)
    x = x.to(torch.float32).to(torch.float64)
    pad = n_fft // 2
    n_ext = x.shape[-1] + 2 * pad
    n_add = (-(n_ext - n_fft)) % hop
    x = torch.nn.functional.pad(x, (pad, pad + n_add))
    frames = x.unfold(-1, n_fft, hop)  # (..., T, n_fft), a view
    win = hann(n_fft, device=x.device, dtype=torch.float64)
    spec = torch.fft.rfft(frames * win, dim=-1) / torch.sum(win)
    return spec.to(torch.complex64).transpose(-1, -2).contiguous()  # (..., F, T)


def istft(
    Z: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 512,
    length: int | None = None,
    precision: str = "exact",
) -> torch.Tensor:
    """Inverse STFT of Z (..., n_freqs, n_frames) -> float32 (..., samples).

    Matches ``scipy.signal.istft(Z, nperseg=n_fft, noverlap=n_fft - hop)[1]``
    (boundary trim included); ``length`` crops or zero-pads the output.
    """
    _check_precision(precision)
    win = hann(n_fft, device=Z.device, dtype=torch.float64)
    # In float64 and rounded once at the end, like the forward transform:
    # cuFFT's float32 C2R plans for large batches are less accurate than the
    # small-batch ones, so in float32 the output would depend on the batch.
    # The imaginary parts of the DC and Nyquist bins are not part of a real
    # signal's spectrum: pocketfft drops them, some cuFFT plans fold them
    # in, so they are dropped explicitly.
    Zt = Z.transpose(-1, -2).to(torch.complex128)
    Zt[..., 0] = Zt[..., 0].real
    if n_fft % 2 == 0:
        Zt[..., n_fft // 2] = Zt[..., n_fft // 2].real
    frames = torch.fft.irfft(Zt, n=n_fft, dim=-1)
    frames = frames * win * torch.sum(win)
    x = _overlap_add(frames, hop)

    n_frames = Z.shape[-1]
    norm = _overlap_add((win * win).expand(n_frames, n_fft), hop)
    x = x / torch.where(norm > 1e-10, norm, torch.ones_like(norm))

    pad = n_fft // 2
    x = (x[..., pad:-pad] if pad else x).to(torch.float32)
    if length is not None:
        if x.shape[-1] >= length:
            x = x[..., :length]
        else:
            x = torch.nn.functional.pad(x, (0, length - x.shape[-1]))
    return x
