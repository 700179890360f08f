"""Closed-form 2x2 complex Hermitian solve (counterpart of
azoom.beam.linalg2x2.solve_2x2_hermitian)."""

from __future__ import annotations

import torch

__all__ = ["solve_2x2_hermitian"]


def solve_2x2_hermitian(R: torch.Tensor, d: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Solve R x = d for Hermitian R (..., 2, 2) and d (..., 2) via adjugate:

        R^-1 = [[c, -b], [-b*, a]] / (a c - |b|^2)
    """
    a = R[..., 0, 0]
    b = R[..., 0, 1]
    c = R[..., 1, 1]
    det = a * c - b * torch.conj(b) + eps
    x0 = (c * d[..., 0] - b * d[..., 1]) / det
    x1 = (a * d[..., 1] - torch.conj(b) * d[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)
