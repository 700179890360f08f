"""Hybrid hard-null beamformer, the Final-generation spatial filter
(counterpart of azoom.beam.nullsteer).

At M = 2:
  1. interference covariance from the (1 - target) mask,
  2. its principal eigenvector in closed form (beam.linalg2x2), rotated so
     that component 0 is real and positive,
  3. constraint matrix C = [d_tgt, v_int]; C^H w = [1, 0] by Cramer's rule,
  4. cond(C) > cond_threshold (or a non-finite weight) -> delay-and-sum
     d_tgt / 2; below ``lowfreq_bypass_hz`` mic 0 passes through.

At M > 2 the norm-constrained LCMV of the reference: C = [d_tgt, v_1 ..
v_J], v_j the J = min(n_nulls, M - 1) principal eigenvectors of the
interference covariance (beam.linalgmm's Jacobi EVD), each kept only where
its eigenvalue exceeds ``_NULL_SIG`` times the noise floor; the weights
w = C (C^H C + delta tr I)^-1 e_0, renormalised to unit target gain, with
the loading delta bisected per bin (``_WNG_BISECT_ITERS`` steps of log
delta) to the smallest that keeps ||w||^2 within wng_limit / M; a gain below
``_GAIN_FLOOR``, a norm over twice that budget or a non-finite weight falls
back to d_tgt / M.

Everything runs in the dtype of its inputs. At M = 2 the fused CUDA kernel
(azoom_torch.kernels.nullsteer_kernel) computes this function in float64;
its plain version calls these functions on complex128 tensors. At M > 2 the
pipelines run it in complex64, the reference's dtype, on any device.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import cond_2x2, eigh_2x2_hermitian, solve_2x2_general
from azoom_torch.beam.linalgmm import eigh_hermitian_small, solve_hermitian_small
from azoom_torch.beam.mvdr import apply_weights

__all__ = ["constraint_matrix", "hard_null_weights", "hybrid_hard_null_beamform"]

# The M > 2 LCMV's knobs, the reference's: the least target gain before the
# delay-and-sum fallback, how far an eigenvalue must dominate the floor
# eigenvalue to earn a null, and the loading bisection's steps.
_GAIN_FLOOR = 0.2
_NULL_SIG = 10.0
_WNG_BISECT_ITERS = 20


def constraint_matrix(R_int: torch.Tensor, d_tgt: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """C = [d_tgt, v_int] (..., F, 2, 2) from the interference covariance
    (..., F, 2, 2) and the phase-normalised target steering (..., F, 2):
    v_int is R_int's principal eigenvector with component 0 made real and
    positive. M = 2 only."""
    if d_tgt.shape[-1] != 2:
        raise ValueError(f"constraint_matrix is the 2-mic construction, got M = {d_tgt.shape[-1]}")
    _, eigvecs = eigh_2x2_hermitian(R_int)
    v_int = eigvecs[..., :, -1]
    phase = v_int[..., :1] / (torch.abs(v_int[..., :1]) + eps)
    v_int = v_int * torch.conj(phase)
    d_b = torch.broadcast_to(d_tgt.to(v_int.dtype), v_int.shape)
    return torch.stack([d_b, v_int], dim=-1)


def hard_null_weights(
    R_int: torch.Tensor,
    d_tgt: torch.Tensor,
    cond_threshold: float = 10.0,
    eps: float = 1e-10,
    n_nulls: int = 1,
    wng_limit: float = 10.0,
) -> torch.Tensor:
    """Null-steering weights (..., F, M) from the interference covariance
    (..., F, M, M) and the phase-normalised target steering (..., F, M).

    M = 2: unit target gain and a hard null on the principal interference
    direction where cond(C) <= cond_threshold, else delay-and-sum.
    M > 2: the norm-constrained LCMV (module docstring) with
    J = min(n_nulls, M - 1) nulls and the white-noise-gain budget
    ``wng_limit`` (relative to delay-and-sum); ``cond_threshold`` acts at
    M = 2 only, ``n_nulls`` and ``wng_limit`` at M > 2 only."""
    M = d_tgt.shape[-1]
    if M > 2:
        return _lcmv_weights(R_int, d_tgt, eps, n_nulls, wng_limit)
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


def _lcmv_weights(R_int, d_tgt, eps, n_nulls, wng_limit):
    """The M > 2 branch of :func:`hard_null_weights`, in the reference's order."""
    M = d_tgt.shape[-1]
    J = max(1, min(n_nulls, M - 1))
    eigvals, eigvecs = eigh_hermitian_small(R_int)
    # A direction earns its null only where its eigenvalue clearly dominates
    # the floor eigenvalue; a zeroed column drops out of the loaded Gram
    # solve, so a bin without significant directions is delay-and-sum.
    ev_floor = eigvals[..., 0] + 1e-3 * torch.sum(eigvals, dim=-1) / M
    d_b = torch.broadcast_to(d_tgt.to(eigvecs.dtype), eigvecs[..., :, 0].shape)
    zero = torch.zeros((), dtype=eigvecs.dtype, device=eigvecs.device)
    cols = [d_b]
    for j in range(J):
        v = eigvecs[..., :, -(j + 1)]
        phase = v[..., :1] / (torch.abs(v[..., :1]) + eps)
        sig = (eigvals[..., -(j + 1)] > _NULL_SIG * ev_floor)[..., None]
        cols.append(torch.where(sig, v * torch.conj(phase), zero))
    C = torch.stack(cols, dim=-1)  # (..., F, M, J + 1)
    G = torch.einsum("...ij,...ik->...jk", torch.conj(C), C)
    tr_g = torch.diagonal(G.real, dim1=-2, dim2=-1).sum(-1) / (J + 1) + 1e-30
    eye = torch.eye(J + 1, dtype=G.dtype, device=G.device)
    rhs = torch.zeros(C.shape[:-2] + (J + 1,), dtype=C.dtype, device=C.device)
    rhs[..., 0] = 1.0

    def w_unit_of(log_delta):
        y = solve_hermitian_small(G + (torch.exp(log_delta) * tr_g)[..., None, None] * eye, rhs)
        w_raw = torch.einsum("...ij,...j->...i", C, y)
        g = torch.einsum("...i,...i->...", torch.conj(w_raw), d_b)
        tiny = (torch.abs(g) < 1e-30).to(g.dtype)
        return w_raw / torch.conj(g[..., None] + tiny[..., None]), torch.abs(g)

    # Bisect log delta to the least loading within the white-noise-gain cap:
    # ||w(delta)|| falls as delta grows, and delta -> inf is delay-and-sum.
    wng_cap = wng_limit / M
    # the bracket's ends are logs taken in the working dtype, as the reference's
    lo, hi = (torch.full(tr_g.shape, float(torch.log(torch.tensor(v, dtype=tr_g.dtype))),
                         dtype=tr_g.dtype, device=tr_g.device) for v in (1e-7, 1e4))
    for _ in range(_WNG_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        w_mid, _ = w_unit_of(mid)
        over = torch.sum(torch.abs(w_mid) ** 2, dim=-1) > wng_cap
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    w, g_abs = w_unit_of(hi)
    w_das = torch.broadcast_to(d_b / M, w.shape)
    bad = (~torch.isfinite(g_abs) | (g_abs < _GAIN_FLOOR)
           | (torch.sum(torch.abs(w) ** 2, dim=-1) > 2.0 * wng_cap))
    w = torch.where(bad[..., None], w_das, w)
    return torch.where(torch.isfinite(w), w, w_das)


def hybrid_hard_null_beamform(
    Y: torch.Tensor,
    target_mask: torch.Tensor,
    d_tgt: torch.Tensor,
    freqs_hz: torch.Tensor,
    lowfreq_bypass_hz: float = 200.0,
    cond_threshold: float = 10.0,
    n_nulls: int = 1,
    wng_limit: float = 10.0,
) -> torch.Tensor:
    """Full hybrid pass on an STFT block Y (..., M, F, T) with the target
    mask (..., F, T) and phase-normalised steering d_tgt (F, M) or (..., F, M)
    -> (..., F, T). Below ``lowfreq_bypass_hz`` mic 0 passes through; the
    caller applies any spectral post-filter. ``n_nulls`` and ``wng_limit``
    act at M > 2 (:func:`hard_null_weights`)."""
    R_int = masked_covariance(Y, 1.0 - target_mask)
    w = hard_null_weights(R_int, d_tgt, cond_threshold, n_nulls=n_nulls, wng_limit=wng_limit)
    S = apply_weights(w, Y)
    bypass = (freqs_hz < lowfreq_bypass_hz)[:, None]
    return torch.where(bypass, Y[..., 0, :, :], S)
