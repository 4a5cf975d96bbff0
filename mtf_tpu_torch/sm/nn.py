"""Nearest-neighbour search method (port of `mtf_tpu/sm/nn.py`), over B
trackers.

At init each tracker samples a dataset of K views of its template under
perturbations dp drawn around the identity (sample 0 is the identity) and
stores their distance features and the inverses dp^-1. An update searches
the dataset for the nearest view of the current patch and applies its
stored correction, up to `max_iters` times: a fixed loop in which a
tracker whose corners moved less than `epsilon` freezes (each tracker
keeps its own count, the semantics of the JAX package's vmapped
`while_loop`). The search is exact (one batched float32 matmul and an
argmin) or, with `use_gnn`, a greedy descent of a kNN graph over the
dataset (a fixed loop of `gnn_max_steps` with a per-tracker stop mask).
With `add_samples_gap > 0` the dataset takes `n_samples_to_add` fresh
views of the current frame around the converged state every
`add_samples_gap` updates, replacing the oldest non-identity samples
(and reconnecting them in the graph).

Draws: the dataset's perturbations are a function of `seed` alone, an
update's online additions of (`seed`, update count); both are made on the
tracker's device, shared by the B trackers (every tracker of a JAX fleet
draws from the same key), and come from `_draw`, which a caller may
override (the parity tests hand it the JAX package's draws).

`update_multi` runs the same update on per-tracker frames (B, H, W, C):
each tracker's search and online additions sample its own frame (a gray
stack (B, H, W, 1) by the dense taps, as an (H, W) frame).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.sm.core import (SearchMethod, TrackerState, converge,
                                   is_gray, points_at, sampler_sigma,
                                   seeded_generator)

# samples per chunk of the dataset build with a dense kind (the JAX
# package's `lax.map` batch size there): bounds the sampler's memory
_CHUNK = 64


@dataclass(frozen=True)
class NNParams:
    """Reference NNParams.h / FLANNParams.h analog (the JAX package's
    fields and defaults)."""
    n_samples: int = 1000
    max_iters: int = 3
    pix_sigma: float = 4.0
    ssm_sigma: tuple = ()      # explicit per-dof sigmas
    epsilon: float = 0.01      # corner-change convergence threshold (px)
    add_samples_gap: int = 0   # updates between online additions; 0: off
    n_samples_to_add: int = 8
    dist_feat: str = "am"      # "am": the AM's `dist_feat`; "raw": the
                               # flat raw patch (L2 on pixels)
    use_gnn: bool = False      # greedy kNN-graph descent
    gnn_k: int = 10
    gnn_max_steps: int = 32
    seed: int = 0


class NNState(NamedTuple):
    """Per-tracker dataset (B leading); `step` takes the place of the JAX
    package's key."""
    feats: torch.Tensor      # (B, K, D) distance features
    feats_sq: torch.Tensor   # (B, K) their squared norms
    dps: torch.Tensor        # (B, K, S) stored corrections dp^-1
    ptr: torch.Tensor        # (B,) int32 ring pointer of online additions
    frame_idx: torch.Tensor  # (B,) int32 updates since initialize
    step: torch.Tensor       # () int64 on the CPU: updates so far
    graph: torch.Tensor | None = None  # (B, K, gnn_k) int64 kNN graph


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) at indices idx (B, ...) along axis 1."""
    b = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def _put(x: torch.Tensor, idx: torch.Tensor, fire: torch.Tensor,
         new: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) with rows idx (B, A) set to new (B, A, ...) where
    fire (B,) is set."""
    old = _rows(x, idx)
    m = fire.view((-1,) + (1,) * (new.dim() - 1))
    i = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return x.scatter(1, i, torch.where(m, new, old))


def build_knn_graph(feats: torch.Tensor, feats_sq: torch.Tensor, k: int,
                    block: int = 256) -> torch.Tensor:
    """kNN graph (B, K, k) of datasets feats (B, K, D): per block of rows
    one distance matmul and the k + 1 nearest (`torch.topk`), then each
    row's own index dropped, the others kept in order."""
    K = feats.shape[1]
    out = []
    for i in range(0, K, block):
        d = (feats_sq[:, i:i + block, None]
             - 2.0 * (feats[:, i:i + block] @ feats.transpose(1, 2))
             + feats_sq[:, None, :])                    # (B, blk, K)
        out.append(torch.topk(-d, k + 1, dim=-1).indices)
    idx = torch.cat(out, dim=1)                          # (B, K, k + 1)
    rows = torch.arange(K, device=feats.device)[:, None]
    order = torch.argsort((idx == rows).to(torch.int8), dim=-1, stable=True)
    return torch.gather(idx, -1, order[..., :k])


class NN(SearchMethod):
    name = "nn"
    SALT = 2

    def __init__(self, am, ssm, prm=None, nn: NNParams | None = None):
        super().__init__(am, ssm, prm)
        self.nn = nn or NNParams()
        if self.nn.dist_feat not in ("am", "raw"):
            raise ValueError(f"unknown nn dist_feat {self.nn.dist_feat!r}")

    def _draw(self, step: int | None, n: int) -> torch.Tensor:
        """(n, S) standard normals: the dataset's (`step` None) or update
        `step`'s online additions (overridable: the parity tests hand in
        the JAX package's)."""
        gen = seeded_generator(self.nn.seed, -1 if step is None else step,
                               self.SALT, self.device)
        return torch.randn((n, self.ssm.dof), generator=gen,
                           device=self.device)

    def _sigma(self, region) -> torch.Tensor:
        """(B, S) perturbation sigmas."""
        return sampler_sigma(self.ssm, region, self.nn.ssm_sigma,
                             self.nn.pix_sigma)

    def _patch_at(self, region, s, frame):
        """Patches (B, ..., N, C) at states s (B, ..., S). A dense kind
        samples a `crop` (default 192) window per state, anchored at its
        own points."""
        pts = points_at(self.ssm, region, s)
        if self.prm.interp.endswith(interp.MM_SUFFIX) and is_gray(frame):
            val, _ = interp.sample_dense(
                frame, pts, self.prm.interp[:-len(interp.MM_SUFFIX)],
                crop=self.prm.crop or 192, need_grad=False)
            return val
        return interp.sample(frame, pts, self.prm.interp, self.prm.border)

    def _dist_feat(self, patch):
        if self.nn.dist_feat == "raw":
            return patch.flatten(-2)
        return self.am.dist_feat(patch)

    def _feat_at(self, region, s, frame):
        return self._dist_feat(self._patch_at(region, s, frame))

    def _draw_dps(self, state: TrackerState) -> torch.Tensor:
        """(B, K, S) dataset perturbations: the shared draw scaled by each
        tracker's sigma; sample 0 is the identity."""
        K = self.nn.n_samples
        dps = self._sigma(state.region)[:, None] * self._draw(None, K)[None]
        dps[:, 0] = 0.0
        return dps

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        nn = self.nn
        K = nn.n_samples
        B = state.ssm_state.shape[0]
        dps = self._draw_dps(state)
        bs = _CHUNK if self.prm.interp.endswith(interp.MM_SUFFIX) else 256
        mine = self._mine(dps)          # the samples this rank featurizes
        feats = torch.cat([self._feat_at(state.region, mine[:, i:i + bs],
                                         frame)
                           for i in range(0, mine.shape[1], bs)],
                          dim=1)                                # (B, K, D)
        # a patch that matches the template seen under dp is corrected by
        # dp^-1: store the inverses
        dps_inv = self.ssm.invert(dps)
        feats_sq = (feats * feats).sum(dim=-1)
        graph = (build_knn_graph(feats, feats_sq, min(nn.gnn_k, K - 1))
                 if nn.use_gnn else None)
        zeros = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return NNState(feats=feats, feats_sq=feats_sq, dps=dps_inv,
                       ptr=zeros, frame_idx=zeros.clone(),
                       step=torch.zeros((), dtype=torch.int64), graph=graph)

    # -- the dataset: all of it here; `ShardedNN` holds and searches its
    # rank's samples
    def _mine(self, dps: torch.Tensor) -> torch.Tensor:
        """The samples (B, K', S) of the dataset's (B, K, S) whose
        features this rank holds."""
        return dps

    def _put_feats(self, x, idx, fire, new):
        """`_put` into this rank's features."""
        return _put(x, idx, fire, new)

    def _best_idx(self, ns: NNState, q: torch.Tensor) -> torch.Tensor:
        """(B,) index of each tracker's nearest dataset sample to its
        query q (B, D)."""
        nn = self.nn
        if not nn.use_gnn:
            scores = ns.feats_sq - 2.0 * (ns.feats @ q[..., None])[..., 0]
            return torch.argmin(scores, dim=-1)
        # greedy descent from the identity node: hop to the nearest
        # neighbour while it improves, each query frozen once it stops
        B = q.shape[0]
        cur = torch.zeros((B,), dtype=torch.int64, device=q.device)
        d_cur = ns.feats_sq[:, 0] - 2.0 * (ns.feats[:, 0] * q).sum(-1)
        stop = torch.zeros((B,), dtype=torch.bool, device=q.device)
        for _ in range(nn.gnn_max_steps):
            neigh = _rows(ns.graph, cur)                       # (B, k)
            d_n = (_rows(ns.feats_sq, neigh)
                   - 2.0 * (_rows(ns.feats, neigh) @ q[..., None])[..., 0])
            j = torch.argmin(d_n, dim=-1, keepdim=True)
            d_j = torch.gather(d_n, 1, j)[:, 0]
            better = (d_j < d_cur) & ~stop
            cur = torch.where(better, torch.gather(neigh, 1, j)[:, 0], cur)
            d_cur = torch.where(better, d_j, d_cur)
            stop = stop | ~better
        return cur

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        ssm, nn = self.ssm, self.nn
        ns: NNState = state.extra
        s = converge(ssm, state.region, state.ssm_state, nn.max_iters,
                     nn.epsilon, lambda s: _rows(ns.dps, self._best_idx(
                         ns, self._feat_at(state.region, s, frame))))
        new_extra = ns._replace(frame_idx=ns.frame_idx + 1, step=ns.step + 1)
        if nn.add_samples_gap > 0:
            new_extra = self._add_samples(state, ns, new_extra, s, frame)
        new_state = state._replace(ssm_state=s, extra=new_extra)
        if not self.am.needs_update_model:
            return new_state
        return new_state._replace(am_state=self.am.update_model(
            state.am_state, self._patch_at(state.region, s, frame)))

    def _add_samples(self, state, ns, new_extra, s_out, frame):
        """The online dataset update: `n_samples_to_add` views of this
        frame around the converged state replace the oldest non-identity
        samples, where this update is one of every `add_samples_gap`."""
        ssm, nn = self.ssm, self.nn
        A, K = nn.n_samples_to_add, nn.n_samples
        dp_new = (self._sigma(state.region)[:, None]
                  * self._draw(int(ns.step), A)[None])        # (B, A, S)
        f_new = self._feat_at(
            state.region, ssm.compositional_update(s_out[:, None], dp_new),
            frame)                                            # (B, A, D)
        dp_inv = ssm.invert(dp_new)
        idx = 1 + (ns.ptr[:, None].long()
                   + torch.arange(A, device=s_out.device)) % (K - 1)
        fire = (ns.frame_idx % nn.add_samples_gap) == 0       # (B,)
        feats = self._put_feats(ns.feats, idx, fire, f_new)
        feats_sq = self._put_feats(ns.feats_sq, idx, fire,
                                   (f_new * f_new).sum(dim=-1))
        new_extra = new_extra._replace(
            feats=feats, feats_sq=feats_sq, dps=_put(ns.dps, idx, fire,
                                                     dp_inv),
            ptr=ns.ptr + torch.where(fire, A, 0).to(ns.ptr.dtype))
        if nn.use_gnn:
            # reconnect the replaced nodes to their kNN in the updated
            # dataset (stale in-edges age out as their owners are replaced)
            kk = ns.graph.shape[-1]
            d = ((f_new * f_new).sum(-1)[..., None]
                 - 2.0 * (f_new @ feats.transpose(1, 2))
                 + feats_sq[:, None, :])                      # (B, A, K)
            d = d.scatter(2, idx[..., None], float("inf"))
            rows = torch.topk(-d, kk, dim=-1).indices
            new_extra = new_extra._replace(graph=_put(ns.graph, idx, fire,
                                                      rows))
        return new_extra

    # -- index persistence (NNParams.h:35-37 save_index / load_index) ---
    def save_index(self, state: TrackerState, path: str) -> None:
        """Write the sample dataset and its corrections to `path`."""
        ex = state.extra
        torch.save({k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                        else v) for k, v in ex._asdict().items()}, path)

    def load_index(self, state: TrackerState, path: str) -> TrackerState:
        """The state with its dataset replaced by the one saved at `path`
        (skips the dataset build)."""
        saved = torch.load(path, weights_only=True)
        ex = NNState(**{k: (v.to(self.device) if isinstance(v, torch.Tensor)
                            and k != "step" else v)
                        for k, v in saved.items()})
        return state._replace(extra=ex)
