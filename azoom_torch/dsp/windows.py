"""Analysis/synthesis window: the periodic Hann window that
scipy.signal.stft uses by default (``get_window('hann', N)``), its NumPy
twin for host-side setup, and the NOLA check of an STFT's invertibility."""

from __future__ import annotations

import math

import numpy as np
import torch


def hann(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window of length n."""
    k = torch.arange(n, device=device, dtype=dtype)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def hann_np(n: int) -> np.ndarray:
    """NumPy twin of :func:`hann` (float64) for host-side setup code."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def check_nola(window: np.ndarray, hop: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add constraint check for iSTFT invertibility."""
    n = len(window)
    if hop > n:
        return False
    binsums = np.zeros(hop)
    for i in range(0, n, hop):
        seg = window[i : i + hop] ** 2
        binsums[: len(seg)] += seg
    return bool(np.min(binsums) > tol * np.max(binsums))
