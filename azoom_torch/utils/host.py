"""Host transfer helper (counterpart of azoom.utils.host): every host-side
consumer of a result (WAV writers, reports, the facade's returns) takes it
through :func:`to_numpy`."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_numpy"]


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (complex included), an array or a scalar ->
    numpy; a numpy array comes back as it is."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(x)
