"""STFT parameter validation and selection (counterpart of
azoom.dsp.params): the STFT -> iSTFT round-trip error of candidate
(n_fft, hop) pairs, and the best pair under a latency bound.

Every pair that satisfies NOLA reconstructs to round-off (~1e-14 MSE), so
``best`` is the argmin of round-off: the port's STFT is float64 inside and
rounds once, the reference's is float32, and the two can pick different
pairs where their MSEs lie within round-off of each other.
"""

from __future__ import annotations

import torch

from azoom_torch.config import as_input
from azoom_torch.dsp.stft import istft, stft
from azoom_torch.dsp.windows import check_nola, hann_np

__all__ = ["stft_reconstruct_mse", "choose_best_stft_params"]


def stft_reconstruct_mse(x, n_fft: int, hop: int, device=None) -> float:
    """Round-trip MSE of STFT -> iSTFT at the given parameters (NumPy input
    runs on CUDA unless ``device="cpu"``)."""
    x = as_input(x, device).to(torch.float32)
    y = istft(stft(x, n_fft, hop), n_fft, hop, length=x.shape[-1])
    return float(torch.mean((x - y) ** 2))


def choose_best_stft_params(
    x,
    candidates: tuple[tuple[int, int], ...] = (
        (256, 128), (512, 128), (512, 256), (1024, 256), (1024, 512), (2048, 512),
    ),
    max_latency_samples: int | None = None,
    device=None,
) -> dict:
    """Grid-search candidate (n_fft, hop) pairs.

    Returns {'best': (n_fft, hop), 'results': {(n_fft, hop): mse, ...}}.
    Pairs violating NOLA (non-invertible) or the latency bound are skipped.
    """
    x = as_input(x, device)
    results: dict = {}
    for n_fft, hop in candidates:
        if max_latency_samples is not None and n_fft > max_latency_samples:
            continue
        if not check_nola(hann_np(n_fft), hop):
            continue
        results[(n_fft, hop)] = stft_reconstruct_mse(x, n_fft, hop)
    if not results:
        raise ValueError("no valid (n_fft, hop) candidates")
    best = min(results, key=results.get)
    return {"best": best, "results": results}
