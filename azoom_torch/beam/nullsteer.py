"""Hybrid hard-null beamformer, the Final-generation spatial filter
(counterpart of azoom.beam.nullsteer for M = 2):

  1. interference covariance from the (1 - target) mask,
  2. its principal eigenvector in closed form (beam.linalg2x2), rotated so
     that component 0 is real and positive,
  3. constraint matrix C = [d_tgt, v_int]; C^H w = [1, 0] by Cramer's rule,
  4. cond(C) > cond_threshold (or a non-finite weight) -> delay-and-sum
     d_tgt / 2; below ``lowfreq_bypass_hz`` mic 0 passes through.

Everything runs in the dtype of its inputs. The fused CUDA kernel
(azoom_torch.kernels.nullsteer_kernel) computes this function in float64;
its plain version calls these functions on complex128 tensors.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import cond_2x2, eigh_2x2_hermitian, solve_2x2_general
from azoom_torch.beam.mvdr import apply_weights

__all__ = ["constraint_matrix", "hard_null_weights", "hybrid_hard_null_beamform"]


def _require_two_mics(M: int) -> None:
    if M != 2:
        raise NotImplementedError(
            "M > 2 hard-null (the norm-constrained LCMV) needs the Jacobi EVD "
            "and Hermitian solve of azoom/beam/linalgmm.py, which is queued "
            "for a later slice of the port"
        )


def constraint_matrix(R_int: torch.Tensor, d_tgt: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """C = [d_tgt, v_int] (..., F, 2, 2) from the interference covariance
    (..., F, 2, 2) and the phase-normalised target steering (..., F, 2):
    v_int is R_int's principal eigenvector with component 0 made real and
    positive."""
    _require_two_mics(d_tgt.shape[-1])
    _, eigvecs = eigh_2x2_hermitian(R_int)
    v_int = eigvecs[..., :, -1]
    phase = v_int[..., :1] / (torch.abs(v_int[..., :1]) + eps)
    v_int = v_int * torch.conj(phase)
    d_b = torch.broadcast_to(d_tgt.to(v_int.dtype), v_int.shape)
    return torch.stack([d_b, v_int], dim=-1)


def hard_null_weights(
    R_int: torch.Tensor, d_tgt: torch.Tensor, cond_threshold: float = 10.0, eps: float = 1e-10
) -> torch.Tensor:
    """Null-steering weights (..., F, 2) with the conditioning fallback:
    unit target gain and a hard null on the principal interference
    direction where cond(C) <= cond_threshold, else delay-and-sum. (The
    reference's ``n_nulls`` and ``wng_limit`` act at M > 2 only.)"""
    C = constraint_matrix(R_int, d_tgt, eps)
    d_b = C[..., 0]
    rhs = torch.zeros_like(d_b)
    rhs[..., 0] = 1.0
    w_null = solve_2x2_general(torch.conj(C).transpose(-1, -2), rhs, eps=eps)
    cond = cond_2x2(C)
    w_das = d_b / 2
    bad = ~torch.isfinite(cond) | (cond > cond_threshold)
    w = torch.where(bad[..., None], w_das, w_null)
    return torch.where(torch.isfinite(w), w, w_das)


def hybrid_hard_null_beamform(
    Y: torch.Tensor,
    target_mask: torch.Tensor,
    d_tgt: torch.Tensor,
    freqs_hz: torch.Tensor,
    lowfreq_bypass_hz: float = 200.0,
    cond_threshold: float = 10.0,
) -> torch.Tensor:
    """Full hybrid pass on an STFT block Y (..., 2, F, T) with the target
    mask (..., F, T) and phase-normalised steering d_tgt (F, 2) or (..., F, 2) ->
    (..., F, T). Below ``lowfreq_bypass_hz`` mic 0 passes through; the
    caller applies any spectral post-filter."""
    _require_two_mics(Y.shape[-3])
    R_int = masked_covariance(Y, 1.0 - target_mask)
    w = hard_null_weights(R_int, d_tgt, cond_threshold)
    S = apply_weights(w, Y)
    bypass = (freqs_hz < lowfreq_bypass_hz)[:, None]
    return torch.where(bypass, Y[..., 0, :, :], S)
