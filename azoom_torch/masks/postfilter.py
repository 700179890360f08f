"""Spectral post-filters beyond the plain mask multiply (counterpart of
azoom.masks.postfilter): ``spectral_floor``, the stage-1 floored mask
multiply, and ``harmonic_regeneration`` (the HRNR post-filter of
beam.postfilter, re-exported here as the reference does)."""

from __future__ import annotations

import torch

from azoom_torch.beam.postfilter import harmonic_regeneration

__all__ = ["harmonic_regeneration", "spectral_floor"]


def spectral_floor(S: torch.Tensor, mask: torch.Tensor, floor: float = 0.05) -> torch.Tensor:
    """Floored mask application: max(mask, floor) * S."""
    return S * torch.clamp(mask, min=floor)
