"""Masked spatial covariance estimation (counterpart of azoom.beam.covariance):

    R[f] = sum_t m[f,t] * Y[:,f,t] Y[:,f,t]^H / (sum_t m[f,t] + eps)

Leading batch dimensions broadcast through.
"""

from __future__ import annotations

import torch

__all__ = ["masked_covariance"]


def masked_covariance(
    Y: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Mask-weighted spatial covariance per frequency bin.

    Args:
      Y: complex STFT (..., M, F, T).
      mask: real weights in [0, 1], shape (..., F, T).
      eps: normalisation guard.

    Returns complex (..., F, M, M) Hermitian covariance matrices.
    """
    m = mask.to(Y.real.dtype)
    R = torch.einsum("...mft,...nft->...fmn", Y * m.unsqueeze(-3), torch.conj(Y))
    norm = torch.sum(m, dim=-1) + eps  # (..., F)
    return R / norm[..., None, None]
