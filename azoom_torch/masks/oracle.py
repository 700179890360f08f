"""Oracle masks from ground-truth stems (counterpart of azoom.masks.oracle).

Convention: noise masks are 1 where interference dominates (they weight the
noise covariance), target masks 1 where the target dominates (post-filters).
All return float32 (..., F, T) from complex STFTs of the two stems.
"""

from __future__ import annotations

import torch

__all__ = ["ibm_noise_mask", "ibm_target_mask", "irm_target_mask", "wiener_target_mask"]


def ibm_noise_mask(S_tgt: torch.Tensor, S_int: torch.Tensor) -> torch.Tensor:
    """Ideal binary mask, 1 where |S_int| > |S_tgt|."""
    return (torch.abs(S_int) > torch.abs(S_tgt)).to(torch.float32)


def ibm_target_mask(S_tgt: torch.Tensor, S_int: torch.Tensor) -> torch.Tensor:
    """Ideal binary mask, 1 where |S_tgt| > |S_int| (the training label)."""
    return (torch.abs(S_tgt) > torch.abs(S_int)).to(torch.float32)


def irm_target_mask(S_tgt: torch.Tensor, S_int: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Ideal ratio mask sqrt(P_t / (P_t + P_i))."""
    P_t = torch.abs(S_tgt) ** 2
    P_i = torch.abs(S_int) ** 2
    return torch.sqrt(P_t / (P_t + P_i + eps)).to(torch.float32)


def wiener_target_mask(S_tgt: torch.Tensor, S_int: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Wiener gain P_t / (P_t + P_i), the squared IRM."""
    P_t = torch.abs(S_tgt) ** 2
    P_i = torch.abs(S_int) ** 2
    return (P_t / (P_t + P_i + eps)).to(torch.float32)
