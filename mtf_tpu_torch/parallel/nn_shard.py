"""Nearest-neighbour search with the sample dataset sharded over a mesh
axis (port of `mtf_tpu/parallel/nn_shard.py`).

  * dataset: the (B, K, S) perturbation draw is the NN's own, made
    whole on every rank; each rank featurizes only its K/n samples (the
    warps and samplings), so the (B, K, D) features stay sharded; the
    stored corrections `dps` (B, K, S) are replicated, so the winner's
    needs no traffic;
  * search: each rank scores its samples (one (K/n, D) x (D,) product
    per tracker) and takes its argmin; the n (distance, global index)
    pairs are all-gathered and the least distance wins, the lowest rank
    (so the lowest global index) on ties, as the unsharded argmin;
  * online additions write the rows that fall in this rank's slice.

GNN graph descent hops between arbitrary samples, which on a sharded
dataset would be a cross-rank gather per hop, so `use_gnn` is rejected.
"""
from __future__ import annotations

import torch

from mtf_tpu_torch.parallel.mesh import axis_shard
from mtf_tpu_torch.sm.nn import NN, NNState, _put


class ShardedNN(NN):
    """NN whose dataset axis is sharded over `mesh[axis]`. Public API
    identical to `NN`; `n_samples` must be divisible by the axis size.
    Its states hold this rank's features (`place` lays out an NN
    state)."""

    def __init__(self, am, ssm, prm=None, nn=None, *, mesh,
                 axis: str = "sample"):
        super().__init__(am, ssm, prm, nn)
        if self.nn.use_gnn:
            raise ValueError(
                "ShardedNN is brute-force exact-NN only; GNN graph descent "
                "does not shard (see module docstring)")
        self.mesh = mesh
        self.axis = axis
        self.shard = axis_shard(mesh, axis)
        if self.nn.n_samples % self.shard.size != 0:
            raise ValueError(
                f"n_samples={self.nn.n_samples} not divisible by "
                f"mesh axis {axis!r} size {self.shard.size}")

    def _mine(self, dps: torch.Tensor) -> torch.Tensor:
        return self.shard.local(dps, 1)

    def place(self, state):
        """An NN state (the whole dataset) with this rank's features."""
        ns: NNState = state.extra
        return state._replace(extra=ns._replace(
            feats=self._mine(ns.feats), feats_sq=self._mine(ns.feats_sq)))

    def _best_idx(self, ns: NNState, q: torch.Tensor) -> torch.Tensor:
        sh = self.shard
        scores = ns.feats_sq - 2.0 * (ns.feats @ q[..., None])[..., 0]
        j = torch.argmin(scores, dim=-1)
        d = torch.gather(scores, 1, j[:, None])[:, 0]
        d_all = sh.gather(d[None])                           # (n, B)
        j_all = sh.gather((j + sh.index * scores.shape[1])[None])
        # the first least distance: the lowest rank, so the lowest global
        # index, as the unsharded argmin
        return torch.gather(j_all, 0, torch.argmin(d_all, dim=0)[None])[0]

    def _put_feats(self, x, idx, fire, new):
        """`_put` of the rows of this rank's slice; the others go to a
        scratch row past its end, dropped after."""
        m = x.shape[1]
        start = self.shard.index * m
        local = idx - start
        inside = (local >= 0) & (local < m)
        pad = torch.zeros_like(x[:, :1])
        out = _put(torch.cat([x, pad], dim=1),
                   torch.where(inside, local, m), fire, new)
        return out[:, :m]
