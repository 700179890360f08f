"""Analysis/synthesis window: the periodic Hann window that
scipy.signal.stft uses by default (``get_window('hann', N)``)."""

from __future__ import annotations

import math

import torch


def hann(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window of length n."""
    k = torch.arange(n, device=device, dtype=dtype)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)
