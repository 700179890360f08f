"""Closed-form 2x2 complex linear algebra (counterpart of
azoom.beam.linalg2x2): the Hermitian solve of the MVDR, and the general
solve, Hermitian eigendecomposition and condition number of the hard-null
beamformer. Everything broadcasts over leading batch dimensions and runs in
the dtype it is given.

Hermitian R has shape (..., 2, 2) with a = R[..., 0, 0] and c = R[..., 1, 1]
real and b = R[..., 0, 1] = conj(R[..., 1, 0]).
"""

from __future__ import annotations

import torch

__all__ = ["solve_2x2_hermitian", "solve_2x2_general", "eigh_2x2_hermitian", "cond_2x2"]


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


def solve_2x2_general(A: torch.Tensor, d: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Solve A x = d for a general complex A (..., 2, 2) by Cramer's rule
    (the hard-null constraint solve C^H w = [1, 0])."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, e = A[..., 1, 0], A[..., 1, 1]
    det = a * e - b * c + eps
    x0 = (e * d[..., 0] - b * d[..., 1]) / det
    x1 = (a * d[..., 1] - c * d[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)


def eigh_2x2_hermitian(R: torch.Tensor, eps: float = 1e-12, rel_tol: float = 1e-6):
    """Eigendecomposition of Hermitian R (..., 2, 2) in closed form.

    Returns (eigvals (..., 2) ascending, eigvecs (..., 2, 2) with unit
    columns), as numpy.linalg.eigh orders them: the principal eigenvector
    is eigvecs[..., :, -1].

    Degeneracy is judged RELATIVE to the matrix scale |tr|/2 + radius: an
    eigenvector candidate whose norm is below rel_tol * scale falls back to
    e0, and an isotropic R (radius < rel_tol * scale) takes the e-basis.
    An absolute threshold would snap quiet but anisotropic covariances to
    the e-basis.
    """
    a = R[..., 0, 0].real
    b = R[..., 0, 1]
    c = R[..., 1, 1].real
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    radius = torch.sqrt(half_diff**2 + (b * torch.conj(b)).real)
    lam_min = half_tr - radius
    lam_max = half_tr + radius
    eigvals = torch.stack([lam_min, lam_max], dim=-1)
    scale = torch.abs(half_tr) + radius + eps
    e0 = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    e0[..., 0] = 1.0
    e1 = torch.flip(e0, dims=(-1,))

    def vec_for(lam):
        # (R - lam I) v = 0 from row 0 or from row 1: take the longer one.
        v1 = torch.stack([b, (lam - a).to(R.dtype)], dim=-1)
        v2 = torch.stack([(lam - c).to(R.dtype), torch.conj(b)], dim=-1)
        n1 = torch.sum(torch.abs(v1) ** 2, dim=-1, keepdim=True)
        n2 = torch.sum(torch.abs(v2) ** 2, dim=-1, keepdim=True)
        v = torch.where(n1 >= n2, v1, v2)
        nsq = torch.sum(torch.abs(v) ** 2, dim=-1, keepdim=True)
        n = torch.sqrt(torch.clamp(nsq, min=eps * eps))
        degenerate = nsq < (rel_tol * scale[..., None]) ** 2
        return torch.where(degenerate, e0, v / n)

    iso = (radius < rel_tol * scale)[..., None]
    v_min = torch.where(iso, e0, vec_for(lam_min))
    v_max = torch.where(iso, e1, vec_for(lam_max))
    return eigvals, torch.stack([v_min, v_max], dim=-1)


def cond_2x2(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """2-norm condition number of a general complex A (..., 2, 2): the
    ratio of its singular values, from the eigenvalues of A^H A."""
    AhA = torch.einsum("...ij,...ik->...jk", torch.conj(A), A)
    eigvals, _ = eigh_2x2_hermitian(AhA)
    s_min = torch.sqrt(torch.clamp(eigvals[..., 0], min=0.0))
    s_max = torch.sqrt(torch.clamp(eigvals[..., 1], min=0.0))
    return s_max / torch.clamp(s_min, min=eps)
