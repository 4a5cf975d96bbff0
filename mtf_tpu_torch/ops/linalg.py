"""Small batched solves as plain tensor code (port of
`mtf_tpu/ops/linalg.py`).

`torch.linalg.cholesky` raises, or returns NaN, on a matrix that is not
positive definite; the Gauss-Newton step must never do either. These
solvers clamp each pivot as the JAX package does, and work over any
number of leading batch dims.
"""
from __future__ import annotations

import torch


def chol_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (..., S, S), b (..., S) by a left-looking
    Cholesky with pivots clamped at sqrt(max(s, 1e-30)), so a matrix that
    is not positive definite gives finite steps instead of an error. S is
    small (Gauss-Newton state dims): each column is one vector step over
    the batch, and the two triangular solves are batched."""
    S = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(S):
        c = A[..., j:, j] - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        d = torch.sqrt(torch.clamp(c[..., :1], min=1e-30))
        L[..., j:, j] = c / d
        L[..., j, j] = d[..., 0]
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def neg_def_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = -H^{-1} g for negative-definite H (GN Hessian at a maximum)."""
    return chol_solve_small(-H, g)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    rows = [[A, -(b * i - c * h), b * f - c * e],
            [B, a * i - c * g, -(a * f - c * d)],
            [C, -(a * h - b * g), a * e - b * d]]
    return torch.stack([torch.stack([v * inv_det for v in r], dim=-1)
                        for r in rows], dim=-2)
