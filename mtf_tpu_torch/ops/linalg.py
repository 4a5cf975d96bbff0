"""Small batched solves as plain tensor code (port of
`mtf_tpu/ops/linalg.py`).

`torch.linalg.cholesky` raises, or returns NaN, on a matrix that is not
positive definite; the Gauss-Newton step must never do either. These
solvers clamp each pivot as the JAX package does, and work over any
number of leading batch dims.
"""
from __future__ import annotations

import torch


def _chol_clamped(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., S, S) by a left-looking column loop
    with pivots clamped at sqrt(max(s, 1e-30)): each column is one vector
    step over the batch."""
    S = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(S):
        c = A[..., j:, j] - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        d = torch.sqrt(torch.clamp(c[..., :1], min=1e-30))
        L[..., j:, j] = c / d
        L[..., j, j] = d[..., 0]
    return L


def _chol_subst(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of L Lᵀ x = b by the two batched triangular solves."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def chol_solve_small(A: torch.Tensor, b: torch.Tensor,
                     jitter: float = 0.0) -> torch.Tensor:
    """Solve A x = b for SPD A (..., S, S), b (..., S) by a Cholesky with
    pivots clamped at sqrt(max(s, 1e-30)), so a matrix that is not
    positive definite gives finite steps instead of an error. S is small
    (Gauss-Newton state dims). `jitter` > 0 adds jitter * I to A first."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype,
                                   device=A.device)
    return _chol_subst(_chol_clamped(A), b)


def chol_solve_blocked(A: torch.Tensor, b: torch.Tensor,
                       nb: int = 8) -> torch.Tensor:
    """Blocked right-looking Cholesky solve for SPD A (..., S, S) with
    S > 12 (the spline and TPS systems, 50 DOF), with the JAX package's
    pivot semantics (`mtf_tpu/ops/linalg.py:chol_solve_blocked`): S is
    padded to a multiple of `nb` with an identity block, each diagonal
    block is factored with clamped pivots after its Schur update, and each
    panel is solved against it. The Schur products are float32 matmuls
    (the package turns TF32 off)."""
    S = A.shape[-1]
    nblk = -(-S // nb)
    Sp = nblk * nb
    if Sp != S:
        pad = Sp - S
        A = torch.nn.functional.pad(A, (0, pad, 0, pad))
        A = A + torch.diag_embed(torch.cat([
            A.new_zeros(S), A.new_ones(pad)])).expand_as(A)
        b = torch.nn.functional.pad(b, (0, pad))

    def blk(i, j):
        return A[..., i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]

    Lb = {}
    for k in range(nblk):
        Akk = blk(k, k)
        for j in range(k):
            Akk = Akk - Lb[k, j] @ Lb[k, j].transpose(-1, -2)
        Lb[k, k] = _chol_clamped(Akk)
        for i in range(k + 1, nblk):
            P = blk(i, k)
            for j in range(k):
                P = P - Lb[i, j] @ Lb[k, j].transpose(-1, -2)
            # X Lkkᵀ = P
            Lb[i, k] = torch.linalg.solve_triangular(
                Lb[k, k].transpose(-1, -2), P, upper=True, left=False)
    zero = A.new_zeros(A.shape[:-2] + (nb, nb))
    L = torch.cat([torch.cat([Lb.get((i, j), zero) for j in range(nblk)],
                             dim=-1) for i in range(nblk)], dim=-2)
    return _chol_subst(L, b)[..., :S]


def neg_def_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = -H^{-1} g for negative-definite H (GN Hessian at a maximum);
    S > 12 takes the blocked solve, as in the JAX package."""
    if H.shape[-1] > 12:
        return chol_solve_blocked(-H, g)
    return chol_solve_small(-H, g)


def solve2x2(H: torch.Tensor, b: torch.Tensor,
             eps: float = 1e-12) -> torch.Tensor:
    """Closed-form solve of 2x2 systems H (..., 2, 2), b (..., 2) (the
    grid's translation systems). A determinant under `eps` in magnitude
    becomes sign(det) * eps + eps, the JAX package's guard (so 0 -> eps)."""
    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    det = torch.where(det.abs() < eps, torch.sign(det) * eps + eps, det)
    x0 = (H[..., 1, 1] * b[..., 0] - H[..., 0, 1] * b[..., 1]) / det
    x1 = (H[..., 0, 0] * b[..., 1] - H[..., 1, 0] * b[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)


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


def lstsq_normal(A: torch.Tensor, b: torch.Tensor,
                 jitter: float = 1e-10) -> torch.Tensor:
    """Least squares min ‖A x - b‖ for A (..., M, K), b (..., M) or
    (..., M, J), by the normal equations with a trace-scaled jitter and
    the clamped Cholesky (the JAX package's DLT solver; K <= ~8)."""
    At = A.transpose(-1, -2)
    AtA = At @ A
    vec = b.dim() == A.dim() - 1
    Atb = At @ (b[..., None] if vec else b)
    k = AtA.shape[-1]
    scale = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) / k
    AtA = AtA + (jitter * scale)[..., None, None] * torch.eye(
        k, dtype=A.dtype, device=A.device)
    x = torch.stack([chol_solve_small(AtA, Atb[..., j])
                     for j in range(Atb.shape[-1])], dim=-1)
    return x[..., 0] if vec else x
