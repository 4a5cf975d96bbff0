"""Gradient-histogram (fHOG-style) features (port of `mtf_tpu/ops/hog.py`)
over any leading batch dims.

Felzenszwalb HOG's layout, as the JAX package re-derives it: each pixel
votes its gradient magnitude for one of 18 signed orientations (the
argmax of its projections on the unit directions, first index on a tie
as `jnp.argmax`), votes are summed per cell, and each cell's 27
orientation channels (18 signed, 9 unsigned) are normalized by its 4
neighbouring 2x2 block energies, truncated at 0.2 and averaged; 4
texture-energy channels (0.2357 x the per-block truncated sums) make 31.
Cells sum their pixels (fHOG splats them bilinearly into 4 cells), as in
the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_HOG_CHANNELS = 31


def cell_pool(img: torch.Tensor, cell: int, reduce: str = "mean"
              ) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/cell, W/cell, C) by cell-wise mean or
    sum (channel-last always: a gray image is passed as (..., H, W, 1))."""
    *lead, h, w, c = img.shape
    hc, wc = h // cell, w // cell
    v = img[..., :hc * cell, :wc * cell, :].reshape(*lead, hc, cell, wc,
                                                    cell, c)
    return v.sum(dim=(-4, -2)) if reduce == "sum" else v.mean(dim=(-4, -2))


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2, W + 2), replicating the edges."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (1, 1, 1, 1),
              mode="replicate")
    return y.reshape(lead + y.shape[-2:])


def _grad(img: torch.Tensor):
    """Central-difference gradients with replicate edges -> (gx, gy),
    each (..., H, W)."""
    p = _edge_pad(img)
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def hog(patch: torch.Tensor, n_orient: int = 9, cell: int = 4,
        eps: float = 1e-4, clip: float = 0.2) -> torch.Tensor:
    """fHOG-style features of gray patches (..., H, W) ->
    (..., H // cell, W // cell, 3 * n_orient + 4)."""
    gx, gy = _grad(patch)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)

    # snap each pixel to one of 2n signed orientations by max dot product
    n2 = 2 * n_orient
    theta = math.pi * (torch.arange(n2, dtype=patch.dtype,
                                    device=patch.device) / n_orient)
    proj = gx[..., None] * torch.cos(theta) + gy[..., None] * torch.sin(theta)
    onehot = F.one_hot(proj.argmax(-1), n2).to(patch.dtype)
    votes = mag[..., None] * onehot                      # (..., H, W, 2n)

    hist = cell_pool(votes, cell, reduce="sum")          # (..., Hc, Wc, 2n)
    u = hist[..., :n_orient] + hist[..., n_orient:]      # insensitive (n,)

    # 4 neighbouring 2x2 block energies per cell (replicate at borders)
    ep = _edge_pad(torch.sum(u * u, dim=-1))             # (..., Hc+2, Wc+2)
    c0 = ep[..., 1:-1, 1:-1]
    n_, s_ = ep[..., :-2, 1:-1], ep[..., 2:, 1:-1]
    w_, e_ = ep[..., 1:-1, :-2], ep[..., 1:-1, 2:]
    nw, ne = ep[..., :-2, :-2], ep[..., :-2, 2:]
    sw, se = ep[..., 2:, :-2], ep[..., 2:, 2:]
    blocks = torch.stack([c0 + n_ + w_ + nw, c0 + n_ + e_ + ne,
                          c0 + s_ + w_ + sw, c0 + s_ + e_ + se])
    inv = torch.rsqrt(blocks + eps)[..., None]           # (4, ..., Hc, Wc, 1)

    v27 = torch.cat([hist, u], dim=-1)                   # (..., Hc, Wc, 3n)
    feat = 0.5 * torch.sum(torch.clamp(v27[None] * inv, max=clip), dim=0)
    texture = 0.2357 * torch.sum(torch.clamp(hist[None] * inv, max=clip),
                                 dim=-1)                 # (4, ..., Hc, Wc)
    return torch.cat([feat, torch.movedim(texture, 0, -1)], dim=-1)
