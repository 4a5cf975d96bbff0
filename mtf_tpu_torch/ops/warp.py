"""Homogeneous-coordinate warp algebra (port of `mtf_tpu/ops/warp.py`).

Conventions follow the JAX package: points are (..., N, 2) in (x, y)
order, corners are (..., 4, 2) in MTF order ul, ur, lr, ll, warps are
(..., 3, 3). Every function takes any number of leading batch dims.
"""
from __future__ import annotations

import torch

from mtf_tpu_torch.ops.linalg import chol_solve_small, inv3x3, lstsq_normal


def homogenize(pts: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 3) by appending ones."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def dehomogenize(pts_h: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2) perspective division."""
    return pts_h[..., :2] / pts_h[..., 2:3]


def apply_warp(w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """dehom(W @ hom(p)) for warps (..., 3, 3) and points (..., N, 2).

    Full float32 (the package turns TF32 off): warped coordinates live
    at image scale, where reduced-precision operands bias tracking."""
    return dehomogenize(torch.matmul(homogenize(pts), w.transpose(-1, -2)))


def unit_square_corners(dtype=torch.float32, device=None) -> torch.Tensor:
    """Centered unit square corners (ul, ur, lr, ll), y pointing down."""
    return torch.tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                        dtype=dtype, device=device)


def unit_square_grid(resx: int, resy: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(resy*resx, 2) uniform grid over the centered unit square,
    row-major (y outer, x inner)."""
    xs = torch.linspace(-0.5, 0.5, resx, dtype=dtype, device=device)
    ys = torch.linspace(-0.5, 0.5, resy, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def _eye3_like(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(
        x.shape[:-2] + (3, 3)).clone()


def normalize_pts(pts: torch.Tensor, eps: float = 1e-12):
    """Hartley normalization of (..., N, 2): returns (pts_n, T) with
    ``pts_n = apply_warp(T, pts)``."""
    c = pts.mean(dim=-2)                                     # (..., 2)
    d = torch.linalg.vector_norm(pts - c[..., None, :], dim=-1).mean(dim=-1)
    s = (2.0 ** 0.5) / (d + eps)
    T = _eye3_like(pts[..., :3, :])
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * c[..., 0]
    T[..., 1, 2] = -s * c[..., 1]
    return (pts - c[..., None, :]) * s[..., None, None], T


def homography_dlt(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT homography with dst ~ W @ src, for (..., N, 2)
    correspondences and optional per-point weights (..., N) (robust
    refits: each point's two rows scaled by sqrt(max(w, 0))). As in the
    JAX package, the h22 = 1 gauge turns the fit into an 8x8
    normal-equation solve on the unrolled Cholesky."""
    src_n, Ts = normalize_pts(src)
    dst_n, Td = normalize_pts(dst)
    x, y = src_n[..., 0], src_n[..., 1]
    X, Y = dst_n[..., 0], dst_n[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -X * x, -X * y, -X], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -Y * x, -Y * y, -Y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                          # (..., 2N, 9)
    if weights is not None:
        wsq = torch.sqrt(torch.clamp(weights, min=0.0))
        A = A * torch.cat([wsq, wsq], dim=-1)[..., None]
    AtA = A.transpose(-1, -2) @ A
    scale = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) / 9.0
    M = AtA[..., :8, :8] + (1e-9 * scale)[..., None, None] * torch.eye(
        8, dtype=A.dtype, device=A.device)
    h8 = chol_solve_small(M, -AtA[..., :8, 8])
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    Wn = h.reshape(h.shape[:-1] + (3, 3))
    W = inv3x3(Td) @ Wn @ Ts
    return W / W[..., 2:3, 2:3]


def affine_dlt(src: torch.Tensor, dst: torch.Tensor,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares affine warp (..., 3, 3), last row [0, 0, 1], with
    dst ~ W @ src for (..., N, 2) correspondences and optional per-point
    weights (..., N) (rows scaled by sqrt(max(w, 0)))."""
    A = homogenize(src)                                      # (..., N, 3)
    b = dst
    if weights is not None:
        wsq = torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
        A, b = A * wsq, b * wsq
    sol = lstsq_normal(A, b)                                 # (..., 3, 2)
    W = _eye3_like(src[..., :3, :])
    W[..., :2, :] = sol.transpose(-1, -2)
    return W


def similitude_dlt(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares similitude [[a, -b, tx], [b, a, ty], [0, 0, 1]] for
    (..., N, 2) correspondences and optional weights (..., N)."""
    x, y = src[..., 0], src[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    A = torch.cat([torch.stack([x, -y, o, z], dim=-1),
                   torch.stack([y, x, z, o], dim=-1)], dim=-2)  # (..., 2N, 4)
    b = torch.cat([dst[..., 0], dst[..., 1]], dim=-1)
    if weights is not None:
        wsq = torch.sqrt(torch.clamp(weights, min=0.0))
        wsq2 = torch.cat([wsq, wsq], dim=-1)
        A, b = A * wsq2[..., None], b * wsq2
    a, bb, tx, ty = lstsq_normal(A, b).unbind(-1)
    W = _eye3_like(src[..., :3, :])
    W[..., 0, 0], W[..., 0, 1], W[..., 0, 2] = a, -bb, tx
    W[..., 1, 0], W[..., 1, 1], W[..., 1, 2] = bb, a, ty
    return W


def homography_from_unit_square(corners: torch.Tensor) -> torch.Tensor:
    """Closed-form homography mapping the centered unit square onto
    corners (..., 4, 2) (projective texture-mapping formula)."""
    x0, y0 = corners[..., 0, 0], corners[..., 0, 1]
    x1, y1 = corners[..., 1, 0], corners[..., 1, 1]
    x2, y2 = corners[..., 2, 0], corners[..., 2, 1]
    x3, y3 = corners[..., 3, 0], corners[..., 3, 1]
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    g = (dx3 * dy2 - dx2 * dy3) / den
    h = (dx1 * dy3 - dx3 * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    H = torch.stack([torch.stack([a, b, x0], -1),
                     torch.stack([d, e, y0], -1),
                     torch.stack([g, h, torch.ones_like(g)], -1)], -2)
    # centered square -> [0, 1]^2 first
    A = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]],
                     dtype=corners.dtype, device=corners.device)
    return H @ A


def grid_from_corners(corners: torch.Tensor, resx: int,
                      resy: int) -> torch.Tensor:
    """(..., resy*resx, 2) sampling grid inside corner quads (..., 4, 2),
    through the DLT homography from the unit square."""
    sq = unit_square_corners(corners.dtype, corners.device).expand(
        corners.shape)
    H = homography_dlt(sq, corners)
    grid = unit_square_grid(resx, resy, corners.dtype, corners.device)
    return apply_warp(H, grid.expand(corners.shape[:-2] + grid.shape))
