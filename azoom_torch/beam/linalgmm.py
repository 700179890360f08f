"""Small-M complex Hermitian linear algebra for arrays of M > 2 mics
(counterpart of azoom.beam.linalgmm).

The covariance, steering and sweep layers are shaped (..., F, M, M) for any
M; the M-mic beamformers need a batched Hermitian solve and eigendecomposition
on top. Mic counts are small (2-8), so the Cholesky factorization, the
triangular solves and the Jacobi sweeps are unrolled over M in Python: every
operation is elementwise over the (..., F) batch, in the reference's order.
At M = 2 :func:`solve_hermitian` and :func:`eigh_hermitian_small` return the
closed forms of beam.linalg2x2 unchanged.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.linalg2x2 import eigh_2x2_hermitian, solve_2x2_hermitian

__all__ = ["cholesky_small", "solve_hermitian_small", "solve_hermitian", "eigh_hermitian_small"]


def cholesky_small(R: torch.Tensor, eps: float = 1e-7) -> list[list[torch.Tensor | None]]:
    """Unrolled Cholesky R = L L^H of (..., M, M) Hermitian PSD matrices.

    Returns the lower factor as an M x M list of lists of (...,) tensors
    (None above the diagonal). The pivots are clamped RELATIVE to the
    matrix scale (``eps`` x the largest diagonal entry, + 1e-30), so a
    semidefinite input (a coherent source, a silent channel) gives a bounded
    solution instead of overflowing to NaN."""
    M = R.shape[-1]
    diag_max = R[..., 0, 0].real
    for j in range(1, M):
        diag_max = torch.maximum(diag_max, R[..., j, j].real)
    floor = eps * diag_max + 1e-30
    L: list[list[torch.Tensor | None]] = [[None] * M for _ in range(M)]
    for j in range(M):
        s = R[..., j, j]
        for k in range(j):
            s = s - L[j][k] * torch.conj(L[j][k])
        piv = torch.sqrt(torch.maximum(s.real, floor))
        L[j][j] = piv.to(R.dtype)
        for i in range(j + 1, M):
            t = R[..., i, j]
            for k in range(j):
                t = t - L[i][k] * torch.conj(L[j][k])
            L[i][j] = t / L[j][j]
    return L


def solve_hermitian_small(R: torch.Tensor, d: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Solve R x = d for Hermitian PSD R (..., M, M) and d (..., M), any M:
    the unrolled Cholesky, then forward and back substitution."""
    M = R.shape[-1]
    L = cholesky_small(R, eps)
    y: list[torch.Tensor] = []
    for i in range(M):  # L y = d
        s = d[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x: list[torch.Tensor | None] = [None] * M
    for i in reversed(range(M)):  # L^H x = y, L^H[i, k] = conj(L[k][i])
        s = y[i]
        for k in range(i + 1, M):
            s = s - torch.conj(L[k][i]) * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve_hermitian(R: torch.Tensor, d: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Hermitian solve by mic count: the closed-form adjugate at M = 2 (``eps``
    added to the determinant), the unrolled Cholesky above (``eps`` the
    relative pivot clamp, 1e-7 when 0)."""
    if R.shape[-1] == 2:
        return solve_2x2_hermitian(R, d, eps=eps)
    return solve_hermitian_small(R, d, eps=eps if eps > 0.0 else 1e-7)


def eigh_hermitian_small(R: torch.Tensor, sweeps: int = 6) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of (..., M, M) Hermitian matrices for small M by
    cyclic Jacobi, each rotation the closed-form 2x2 EVD of the (p, q) block.

    Returns (eigvals (..., M) ascending, eigvecs (..., M, M) with unit
    columns), as numpy.linalg.eigh orders them: R = U diag(eigvals) U^H and
    the principal eigenvector is eigvecs[..., :, -1]. The sort is stable, as
    the reference's, so tied eigenvalues keep their columns' order. At M = 2
    the closed form itself."""
    M = R.shape[-1]
    if M == 2:
        return eigh_2x2_hermitian(R)
    A = R.clone()  # written in place below; the input stays as it is
    U = torch.eye(M, dtype=R.dtype, device=R.device).expand(R.shape).clone()
    for _ in range(sweeps):
        for p in range(M - 1):
            for q in range(p + 1, M):
                blk = torch.stack([torch.stack([A[..., p, p], A[..., p, q]], dim=-1),
                                   torch.stack([A[..., q, p], A[..., q, q]], dim=-1)], dim=-2)
                _, V = eigh_2x2_hermitian(blk)
                v00, v10 = V[..., 0, 0][..., None], V[..., 1, 0][..., None]
                v01, v11 = V[..., 0, 1][..., None], V[..., 1, 1][..., None]
                # A <- G^H A G, G = I but for the (p, q) block V: columns, then rows
                colp = A[..., :, p] * v00 + A[..., :, q] * v10
                colq = A[..., :, p] * v01 + A[..., :, q] * v11
                A[..., :, p], A[..., :, q] = colp, colq
                rowp = torch.conj(v00) * A[..., p, :] + torch.conj(v10) * A[..., q, :]
                rowq = torch.conj(v01) * A[..., p, :] + torch.conj(v11) * A[..., q, :]
                A[..., p, :], A[..., q, :] = rowp, rowq
                up = U[..., :, p] * v00 + U[..., :, q] * v10
                uq = U[..., :, p] * v01 + U[..., :, q] * v11
                U[..., :, p], U[..., :, q] = up, uq
    ev = torch.diagonal(A, dim1=-2, dim2=-1).real
    order = torch.argsort(ev, dim=-1, stable=True)
    return (torch.take_along_dim(ev, order, dim=-1),
            torch.take_along_dim(U, order[..., None, :], dim=-1))
