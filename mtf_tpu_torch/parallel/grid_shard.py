"""Grid tracker with its patches and RANSAC hypotheses sharded over a
mesh axis (port of `mtf_tpu/parallel/grid_shard.py`).

  * patch flow: each rank runs the grid's coarse-to-fine flow
    (`GridTracker._track_patches_pyr`, so the grid-flow kernel K5 / K5c
    on the card) on its P/n patches; the (B, P, 2) displacements are
    all-gathered. Each level's window is anchored on the whole patch
    cloud (an all-reduce of its least coordinate), so every patch reads
    the window it reads unsharded;
  * robust fit: the (H, sample) hypothesis draw is the grid's own, made
    whole on every rank; each rank fits and scores its H/n hypotheses
    against every correspondence and keeps its best; the n best are
    all-gathered and the winner (the lowest rank, so the lowest global
    index, on ties, as the unsharded argmax / argmin) has its inlier
    weights refitted replicated.

Populations not divisible by the axis are padded by repeating their last
row: a repeated patch's displacement is dropped, and a repeated
hypothesis never beats the one it repeats. So a sharded update is the
unsharded one. RKLT composes it unchanged: hand a `ShardedGridTracker`
to `sm.composite.RKLT` as its grid stage.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.parallel.mesh import all_reduce, axis_shard
from mtf_tpu_torch.sm.grid import _GRID_MARGIN, GridParams, GridTracker


def _pad_to(x: torch.Tensor, m: int, dim: int = 0) -> torch.Tensor:
    """x padded along `dim` to a multiple of m by repeating its last
    slice."""
    pad = (-x.shape[dim]) % m
    if pad == 0:
        return x
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([x, last.expand(
        x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim=dim)


class ShardedGridTracker(GridTracker):
    """GridTracker whose patch and hypothesis populations shard over
    `mesh[axis]`. Public API and state identical to `GridTracker`'s."""

    name = "grid_sharded"

    def __init__(self, am, ssm, prm=None, grid: GridParams | None = None,
                 *, mesh, axis: str = "patch"):
        super().__init__(am, ssm, prm, grid)
        self.mesh = mesh
        self.axis = axis
        self.shard = axis_shard(mesh, axis)

    # -- patch flow: this rank's patches -----------------------------------
    def _track_patches_pyr(self, frames, norm_mat, pts_base, templates):
        sh = self.shard
        P = pts_base.shape[1]
        pts = _pad_to(pts_base, sh.size, 1)
        rows = sh.rows(pts.shape[1])
        disp = super()._track_patches_pyr(
            frames, norm_mat, pts[:, rows],
            _pad_to(templates, sh.size, 2)[:, :, rows])
        return sh.gather(disp, 1)[:, :P]

    def _window_start(self, v: torch.Tensor, size: int,
                      full: int) -> torch.Tensor:
        lo = all_reduce(v.amin(-1), dist.ReduceOp.MIN, self.shard.group)
        return interp.crop_origin(lo[:, None], size, full, _GRID_MARGIN)

    # -- robust fit: this rank's hypotheses --------------------------------
    def _my_hyps(self, idx: torch.Tensor) -> torch.Tensor:
        idx = _pad_to(idx, self.shard.size, 0)
        return idx[self.shard.rows(idx.shape[0])]

    def _select_hyp(self, key: torch.Tensor, w: torch.Tensor,
                    maximize: bool) -> torch.Tensor:
        keys = self.shard.gather(key[None])                   # (n, B)
        ws = self.shard.gather(w[None])                       # (n, B, N)
        k = keys.argmax(0) if maximize else keys.argmin(0)
        return torch.gather(ws, 0, k[None, :, None].expand(
            (1,) + w.shape))[0]
