"""TLD (Tracking-Learning-Detection, Kalal et al. TPAMI'12; port of
`mtf_tpu/sm/tld.py`) over a leading batch of B trackers.

A Median Flow leg (the port's `GridTracker` with `flow="f2f"`, so K5 runs
on this path) beside a sliding-window detection cascade (variance filter,
random-fern ensemble, NN template match), re-trained online by the P/N
experts, as the JAX package builds it:

- detection runs in a canonical scale pyramid: each level resamples the
  frame so that the target is `win` px, and every window of a level is the
  same `win` square on a strided grid. The variance filter reads an
  integral image (`ops/scan.py`: the JAX package's summation order, so
  each window's variance and so each threshold test is the JAX
  package's), and each fern bit compares two strided views of the level;
- the fern posterior is one gather per frame from (B, trees, 2^feats)
  counts; learning adds the P/N experts' windows into them by
  `scatter_add_` (the JAX `segment_sum`);
- the NN stage matches the top-K fern windows, a ring of 9 windows around
  the last box and the tracker's window against fixed-capacity template
  sets (ring buffers);
- re-acquisition: when the tracker leg is invalid and a detection clears
  the conservative gate, the fused box jumps to it and the leg is
  re-anchored there (`set_region`).

The fern pixel pairs are drawn at construction from
`np.random.default_rng(seed)`, as in the JAX package. The top-K windows
are taken by a stable descending sort, so ties (windows of equal score,
e.g. every untrained posterior at 0) go to the lower index, as
`lax.top_k` takes them; `argmax` and `argmin` take the first index, as in
the JAX package. Every frame read is a sample of the gray frame, so
`update_multi` takes per-tracker frames (B, H, W[, C]).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.scan import cumsum2
from mtf_tpu_torch.sm.cf import _center_size_of, _corners_of
from mtf_tpu_torch.sm.core import multi_frames


@dataclass(frozen=True)
class TLDParams:
    """Defaults follow `DetectorCascade.cpp:56-70` (10 trees x 13
    features, variance threshold at half the init variance) and
    `NNClassifier.h`."""
    win: int = 16            # canonical fern window
    nn_res: int = 15         # NN patch resolution (TLD_PATCH_SIZE)
    levels: int = 5          # canonical scale levels, ratio**(k - L//2)
    ratio: float = 1.2       # scale step between windows
    canon_h: int = 144       # canonical detection image (per level)
    canon_w: int = 192
    stride: int = 2          # window stride in canonical px
    n_trees: int = 10
    n_feats: int = 13
    kp: int = 32             # NN positive template slots
    kn: int = 64             # NN negative template slots
    top_k: int = 8           # fern candidates promoted to the NN stage
    theta_tp: float = 0.6    # re-acquisition confidence gate
    theta_fp: float = 0.55   # tracker-validity floor
    var_ratio: float = 0.5
    pos_iou: float = 0.6     # P-expert overlap
    neg_iou: float = 0.2     # N-expert overlap ceiling
    seed: int = 0


class TLDState(NamedTuple):
    trk: object              # the Median Flow leg's TrackerState
    center: torch.Tensor     # (B, 2) fused box centers (image px)
    size: torch.Tensor       # (B, 2) fused box w, h
    valid: torch.Tensor      # (B,) bool: output trusted (learning on)
    var_min: torch.Tensor    # (B,) variance floor
    fern_pos: torch.Tensor   # (B, T, 2^F) positive counts
    fern_neg: torch.Tensor   # (B, T, 2^F)
    pos_set: torch.Tensor    # (B, KP, nn_res^2) zero-mean unit-norm patches
    pos_valid: torch.Tensor  # (B, KP)
    neg_set: torch.Tensor    # (B, KN, nn_res^2)
    neg_valid: torch.Tensor  # (B, KN)
    pos_ptr: torch.Tensor    # (B,) int32 ring pointers
    neg_ptr: torch.Tensor


def _iou(c1, s1, c2, s2):
    """Axis-aligned IoU; centers and sizes (..., 2), broadcast."""
    lo = torch.maximum(c1 - s1 / 2, c2 - s2 / 2)
    hi = torch.minimum(c1 + s1 / 2, c2 + s2 / 2)
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    return inter / torch.clamp(torch.prod(s1, dim=-1) + torch.prod(s2, dim=-1)
                               - inter, min=1e-6)


def _top_k(score: torch.Tensor, k: int):
    """(values, indices) of each row's k largest scores, ties to the lower
    index (`lax.top_k`)."""
    v, i = torch.sort(score, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[b, i[b, ...]] for every tracker b: x (B, M, ...), i (B, ...)."""
    ar = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (i.dim() - 1))
    return x[ar, i]


class TLD(nn.Module):
    """TLD around a Median Flow leg (any box-reporting SM; the factory
    passes the port's `GridTracker`)."""

    name = "tld"

    def __init__(self, mf_leg, prm: TLDParams | None = None):
        super().__init__()
        self.mf = mf_leg
        self.ssm = mf_leg.ssm
        self.prm = prm or TLDParams()
        p, dev = self.prm, self.device
        rng = np.random.default_rng(p.seed)
        # fern pixel pairs inside the canonical window, drawn once
        self._pairs = rng.integers(
            0, p.win, size=(p.n_trees, p.n_feats, 2, 2)).astype(np.int32)
        self._n_idx = 2 ** p.n_feats
        self._gh = (p.canon_h - p.win) // p.stride + 1
        self._gw = (p.canon_w - p.win) // p.stride + 1
        self._r = np.float32(p.ratio) ** (
            np.arange(p.levels, dtype=np.float32) - p.levels // 2)
        self.register_buffer("_rt", torch.tensor(self._r, device=dev),
                             persistent=False)
        st = p.stride
        ys = np.arange(self._gh) * st
        xs = np.arange(self._gw) * st
        # each tree's bit-f row and column indices of both pixels
        self.register_buffer("_pair_rows", torch.tensor(
            self._pairs[:, :, :, 0, None] + ys[None, None, None, :],
            dtype=torch.int64, device=dev), persistent=False)
        self.register_buffer("_pair_cols", torch.tensor(
            self._pairs[:, :, :, 1, None] + xs[None, None, None, :],
            dtype=torch.int64, device=dev), persistent=False)
        self.register_buffer("_bit", torch.tensor(
            [1 << f for f in range(p.n_feats)], dtype=torch.int64,
            device=dev), persistent=False)
        g = torch.arange(p.nn_res, dtype=torch.float32, device=dev) \
            / (p.nn_res - 1) - 0.5
        self.register_buffer("_nn_grid", g, persistent=False)
        self.register_buffer("_ring", torch.tensor(
            [[dx, dy] for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
            dtype=torch.float32, device=dev), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.mf.device

    # -- frames ---------------------------------------------------------------
    def _gray(self, frame) -> torch.Tensor:
        """The gray frame: (H, W) shared, or (B, H, W, 1) per tracker."""
        frame = torch.as_tensor(frame, dtype=torch.float32,
                                device=self.device)
        if frame.dim() == 3:
            frame = frame.mean(dim=-1)
        elif frame.dim() == 4:
            frame = frame.mean(dim=-1, keepdim=True)
        return frame

    @staticmethod
    def _sample(frame, pts) -> torch.Tensor:
        return interp.sample(frame, pts, "linear")[..., 0]

    # -- canonical pyramid ------------------------------------------------------
    def _canon_levels(self, frame, size, phase=(0.0, 0.0)) -> torch.Tensor:
        """(B, L, canon_h, canon_w): each level resamples the frame so that
        the target at the level's scale is `win` px, canonical pixel (i, j)
        <- image ((j + .5 + phase_x) sx, (i + .5 + phase_y) sy); `phase`
        sub-stride offsets let init training cover shifted alignments."""
        p = self.prm
        sx = size[:, 0, None] * self._rt / p.win                  # (B, L)
        sy = size[:, 1, None] * self._rt / p.win
        xs = (torch.arange(p.canon_w, dtype=torch.float32,
                           device=size.device) + 0.5 + phase[0])
        ys = (torch.arange(p.canon_h, dtype=torch.float32,
                           device=size.device) + 0.5 + phase[1])
        b, L = sx.shape
        X = (xs * sx[..., None])[:, :, None, :].expand(b, L, p.canon_h,
                                                       p.canon_w)
        Y = (ys * sy[..., None])[:, :, :, None].expand(b, L, p.canon_h,
                                                       p.canon_w)
        pts = torch.stack([X, Y], dim=-1).reshape(b, L, -1, 2)
        return self._sample(frame, pts).reshape(b, L, p.canon_h, p.canon_w)

    def _level_maps(self, lv: torch.Tensor):
        """Variance (B, L, gh, gw) of every window and fern indices
        (B, T, L·gh·gw) of every window and tree, from the levels
        (B, L, canon_h, canon_w)."""
        p = self.prm
        w, st = p.win, p.stride
        gh, gw = self._gh, self._gw
        pad = F.pad(lv, (1, 0, 1, 0))
        ii = cumsum2(pad)
        ii2 = cumsum2(pad * pad)

        def box(a):
            return a[..., :gh * st:st, :gw * st:st]

        def rect(a):
            return (box(a[..., w:, w:]) + box(a[..., :-w, :-w])
                    - box(a[..., w:, :-w]) - box(a[..., :-w, w:]))

        n = float(w * w)
        mean = rect(ii) / n
        var = rect(ii2) / n - mean * mean
        trees = []
        for t in range(p.n_trees):
            rows, cols = self._pair_rows[t], self._pair_cols[t]  # (F, 2, g)
            A = lv[:, :, rows[:, 0, :, None], cols[:, 0, None, :]]
            Bv = lv[:, :, rows[:, 1, :, None], cols[:, 1, None, :]]
            bits = (A > Bv).to(torch.int64)                # (B, L, F, gh, gw)
            trees.append((bits * self._bit[:, None, None]).sum(dim=2))
        idx = torch.stack(trees, dim=1)                    # (B, T, L, gh, gw)
        return var, idx.flatten(2)

    @staticmethod
    def _posterior(state) -> torch.Tensor:
        return state.fern_pos / torch.clamp(state.fern_pos + state.fern_neg,
                                            min=1.0)

    def _fern_conf(self, state, idx) -> torch.Tensor:
        """Mean posterior over trees (B, M); idx (B, T, M)."""
        return torch.gather(self._posterior(state), 2, idx).mean(dim=1)

    # -- NN stage ---------------------------------------------------------------
    def _nn_patch(self, frame, center, size) -> torch.Tensor:
        """Zero-mean unit-norm (..., nn_res^2) patches of the boxes at
        centers and sizes (B, ..., 2)."""
        g = self._nn_grid
        lead = center.shape[:-1]
        n = g.shape[0]
        gx = (g * size[..., 0, None])[..., None, :].expand(lead + (n, n))
        gy = (g * size[..., 1, None])[..., :, None].expand(lead + (n, n))
        pts = torch.stack([gx.reshape(lead + (-1,)) + center[..., 0, None],
                           gy.reshape(lead + (-1,)) + center[..., 1, None]],
                          dim=-1)
        v = self._sample(frame, pts)
        v = v - v.mean(dim=-1, keepdim=True)
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-6)

    def _rel_sim(self, state, patches, conservative=False) -> torch.Tensor:
        """Relative similarity (B, K) of patches (B, K, P): distances
        d = (1 - ncc) / 2 to the closest positive and negative templates,
        rel = dN / (dN + dP), empty sets at distance 1; `conservative`
        keeps the positive set's first half of slots (the earliest
        templates)."""
        def dmin(tset, tvalid):
            d = (1.0 - patches @ tset.transpose(1, 2)) * 0.5
            d = torch.where(tvalid[:, None, :] > 0.5, d, 1.0)
            return d.amin(dim=-1)

        pv = state.pos_valid
        if conservative:
            half = max(1, pv.shape[1] // 2)
            pv = pv * (torch.arange(pv.shape[1], device=pv.device) < half)
        dp = dmin(state.pos_set, pv)
        dn = dmin(state.neg_set, state.neg_valid)
        return dn / torch.clamp(dn + dp, min=1e-6)

    # -- window geometry ----------------------------------------------------------
    def _window_boxes(self, size):
        """Centers (B, L, gh, gw, 2) and sizes (B, L, 2) of every canonical
        window in image coordinates."""
        p = self.prm
        sx = size[:, 0, None] * self._rt / p.win                  # (B, L)
        sy = size[:, 1, None] * self._rt / p.win
        cx = torch.arange(self._gw, dtype=torch.float32,
                          device=size.device) * p.stride + p.win / 2
        cy = torch.arange(self._gh, dtype=torch.float32,
                          device=size.device) * p.stride + p.win / 2
        b, L = sx.shape
        CX = (cx[None, None, None, :] * sx[:, :, None, None]).expand(
            b, L, self._gh, self._gw)
        CY = (cy[None, None, :, None] * sy[:, :, None, None]).expand(
            b, L, self._gh, self._gw)
        sizes = torch.stack([size[:, 0, None] * self._rt,
                             size[:, 1, None] * self._rt], dim=-1)
        return torch.stack([CX, CY], dim=-1), sizes

    def _detect(self, state, frame, phase=(0.0, 0.0)):
        """The cascade over the pyramid: (var (B, L, gh, gw), conf (B, L,
        gh, gw), idx (B, T, M), centers (B, L, gh, gw, 2), sizes
        (B, L, 2))."""
        p = self.prm
        var, idx = self._level_maps(self._canon_levels(frame, state.size,
                                                       phase))
        conf = self._fern_conf(state, idx).reshape(var.shape)
        centers, sizes = self._window_boxes(state.size)
        if phase != (0.0, 0.0):
            # phase shifts every window center by the same sub-stride amount
            sxy = torch.stack([state.size[:, 0, None] * self._rt / p.win,
                               state.size[:, 1, None] * self._rt / p.win],
                              dim=-1)                          # (B, L, 2)
            centers = centers + torch.tensor(
                phase, device=sxy.device) * sxy[:, :, None, None, :]
        return var, conf, idx, centers, sizes

    def _flat_boxes(self, centers, sizes):
        """The windows' centers and sizes as (B, M, 2) each."""
        b = centers.shape[0]
        return (centers.reshape(b, -1, 2),
                sizes.repeat_interleave(self._gh * self._gw, dim=1))

    # -- protocol -----------------------------------------------------------------
    def initialize(self, frame, corners_img) -> TLDState:
        """B trackers on one frame from corners (B, 4, 2)."""
        p, dev = self.prm, self.device
        frame = self._gray(frame)
        corners_img = torch.as_tensor(corners_img, dtype=torch.float32,
                                      device=dev)
        center, size = _center_size_of(corners_img)
        b = center.shape[0]
        trk = self.mf.initialize(frame, corners_img)
        P = p.nn_res * p.nn_res
        pos_set = torch.zeros((b, p.kp, P), device=dev)
        pos_set[:, 0] = self._nn_patch(frame, center, size)
        pos_valid = torch.zeros((b, p.kp), device=dev)
        pos_valid[:, 0] = 1.0
        st = TLDState(
            trk=trk, center=center, size=size,
            valid=torch.ones((b,), dtype=torch.bool, device=dev),
            var_min=torch.zeros((b,), device=dev),
            fern_pos=torch.zeros((b, p.n_trees, self._n_idx), device=dev),
            fern_neg=torch.zeros((b, p.n_trees, self._n_idx), device=dev),
            pos_set=pos_set, pos_valid=pos_valid,
            neg_set=torch.zeros((b, p.kn, P), device=dev),
            neg_valid=torch.zeros((b, p.kn), device=dev),
            pos_ptr=torch.ones((b,), dtype=torch.int32, device=dev),
            neg_ptr=torch.zeros((b,), dtype=torch.int32, device=dev))
        # variance floor from the init window
        var, _, idx, centers, sizes = self._detect(st, frame)
        mid = var[:, p.levels // 2].reshape(b, -1)
        ci = torch.sum((centers[:, p.levels // 2].reshape(b, -1, 2)
                        - center[:, None, :]) ** 2, dim=-1).argmin(dim=1)
        st = st._replace(var_min=_rows(mid, ci) * p.var_ratio)
        # initial fern training: positives the windows overlapping the init
        # box, negatives every valid far window; phase-jittered passes stand
        # in for the reference's warped positives
        enable = torch.ones((b,), dtype=torch.bool, device=dev)
        st = self._learn_ferns(st, idx, centers, sizes, var, center, size,
                               enable, bootstrap=True)
        for phase in ((1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.5)):
            var_j, _, idx_j, centers_j, sizes_j = self._detect(st, frame,
                                                               phase)
            st = self._learn_ferns(st, idx_j, centers_j, sizes_j, var_j,
                                   center, size, enable, bootstrap=True)
        # seed the NN negatives from the highest-variance far windows
        iou = _iou(centers, sizes[:, :, None, None, :],
                   center[:, None, None, None, :],
                   size[:, None, None, None, :]).reshape(b, -1)
        vflat = var.reshape(b, -1)
        far_score = torch.where((iou < p.neg_iou)
                                & (vflat >= st.var_min[:, None]), vflat, -1.0)
        n_seed = min(8, p.kn)
        _, far_i = _top_k(far_score, n_seed)
        cent_flat, size_flat = self._flat_boxes(centers, sizes)
        neg_set, neg_valid = st.neg_set.clone(), st.neg_valid.clone()
        neg_set[:, :n_seed] = self._nn_patch(frame, _rows(cent_flat, far_i),
                                             _rows(size_flat, far_i))
        neg_valid[:, :n_seed] = 1.0
        return st._replace(neg_set=neg_set, neg_valid=neg_valid,
                           neg_ptr=torch.full((b,), n_seed,
                                              dtype=torch.int32, device=dev))

    def _learn_ferns(self, state, idx, centers, sizes, var, center, size,
                     enable, bootstrap=False):
        """The P/N experts' counts: overlapping windows whose ensemble is
        not yet confident train positive, confident far windows negative
        (`bootstrap`: every valid far window), where `enable` (B,)."""
        p = self.prm
        b = center.shape[0]
        iou = _iou(centers, sizes[:, :, None, None, :],
                   center[:, None, None, None, :],
                   size[:, None, None, None, :]).reshape(b, -1)
        var_ok = (var >= state.var_min[:, None, None, None]).reshape(b, -1)
        conf = self._fern_conf(state, idx)                         # (B, M)
        en = enable.to(torch.float32)[:, None]
        wpos = (iou > p.pos_iou) & (conf < 0.6)
        wneg = (iou < p.neg_iou) & var_ok
        if not bootstrap:
            wneg = wneg & (conf > 0.5)

        def upd(counts, w):
            add = torch.zeros_like(counts).scatter_add_(
                2, idx, (w.to(torch.float32) * en)[:, None, :].expand(
                    -1, idx.shape[1], -1))
            return counts + add

        return state._replace(fern_pos=upd(state.fern_pos, wpos),
                              fern_neg=upd(state.fern_neg, wneg))

    def update(self, state: TLDState, frame) -> TLDState:
        return self._update(state, self._gray(frame))

    def update_multi(self, state: TLDState, frames) -> TLDState:
        """One update of the B trackers, each on its own frame: frames
        (B, H, W) or (B, H, W, C)."""
        frames = multi_frames(frames, self.device)
        if frames.shape[0] != state.center.shape[0]:
            raise ValueError(f"{frames.shape[0]} frames for "
                             f"{state.center.shape[0]} trackers")
        return self._update(state, frames.mean(dim=-1, keepdim=True))

    def _update(self, state: TLDState, frame) -> TLDState:
        p = self.prm
        b = state.center.shape[0]
        dev = state.center.device
        ar = torch.arange(b, device=dev)

        # 1. the tracker leg (Median Flow)
        trk2 = (self.mf.update_multi(state.trk, frame) if frame.dim() == 4
                else self.mf.update(state.trk, frame))
        t_center, t_size = _center_size_of(
            self.mf.corners(trk2).transpose(-1, -2))
        t_finite = torch.isfinite(t_center).all(-1) & (t_size > 1.0).all(-1)
        t_center = torch.where(t_finite[:, None], t_center, state.center)
        t_size = torch.where(t_finite[:, None], t_size, state.size)

        # 2. the detection cascade
        var, conf, idx, centers, sizes = self._detect(state, frame)
        score = torch.where(var >= state.var_min[:, None, None, None], conf,
                            -1.0).reshape(b, -1)
        top_s, top_i = _top_k(score, p.top_k)
        cent_flat, size_flat = self._flat_boxes(centers, sizes)
        # standing local candidates: a 3x3 ring around the last box
        ring_c = state.center[:, None, :] + self._ring * 0.25 \
            * state.size[:, None, :]
        ring_s = state.size[:, None, :].expand(-1, 9, -1)
        cand_c = torch.cat([_rows(cent_flat, top_i), ring_c], dim=1)
        cand_s = torch.cat([_rows(size_flat, top_i), ring_s], dim=1)
        n_cand = p.top_k + 9

        # 3. the NN stage on the candidates and the tracker's window
        pats = self._nn_patch(frame,
                              torch.cat([cand_c, t_center[:, None]], dim=1),
                              torch.cat([cand_s, t_size[:, None]], dim=1))
        rel = self._rel_sim(state, pats)
        gate = torch.where(state.valid, 0.5, 0.2)
        keep = torch.cat([top_s > gate[:, None],
                          torch.ones((b, 9), dtype=torch.bool, device=dev)],
                         dim=1)
        cand_rel = torch.where(keep, rel[:, :n_cand], 0.0)
        det_j = cand_rel.argmax(dim=1)
        det_rel = cand_rel[ar, det_j]
        det_c, det_s = cand_c[ar, det_j], cand_s[ar, det_j]
        trk_rel = rel[:, n_cand]
        det_cons = self._rel_sim(state, pats[ar, det_j][:, None],
                                 conservative=True)[:, 0]

        # 4. fusion: trust the tracker while its window matches the model;
        # re-acquire from a confident detection when it does not
        trk_ok = state.valid & t_finite & (trk_rel > p.theta_fp)
        det_ok = det_rel > p.theta_tp
        reacq = (~trk_ok) & det_ok & (det_cons > p.theta_tp + 0.1)
        agree = trk_ok & det_ok & (_iou(t_center, t_size, det_c, det_s) > 0.5)
        fuse_c = (10.0 * t_center + det_c) / 11.0
        fuse_s = (10.0 * t_size + det_s) / 11.0
        center = torch.where(reacq[:, None], det_c,
                             torch.where(agree[:, None], fuse_c, t_center))
        size = torch.where(reacq[:, None], det_s,
                           torch.where(agree[:, None], fuse_s, t_size))
        # validity follows the box that was output
        new_valid = trk_ok | reacq

        # 5. learning, masked by validity
        st = state._replace(center=center, size=size, valid=new_valid)
        st = self._learn_ferns(st, idx, centers, sizes, var, center, size,
                               new_valid)
        final_pat = self._nn_patch(frame, center, size)
        final_rel = self._rel_sim(st, final_pat[:, None])[:, 0]
        add_pos = new_valid & (final_rel < p.theta_tp + 0.05)
        pslot = (st.pos_ptr % p.kp).long()
        pos_set, pos_valid = st.pos_set.clone(), st.pos_valid.clone()
        pos_set[ar, pslot] = torch.where(add_pos[:, None], final_pat,
                                         pos_set[ar, pslot])
        pos_valid[ar, pslot] = torch.where(add_pos, 1.0, pos_valid[ar, pslot])
        st = st._replace(pos_set=pos_set, pos_valid=pos_valid,
                         pos_ptr=st.pos_ptr + add_pos.to(torch.int32))
        # the hardest far false positive -> the negative set
        far = _iou(cand_c, cand_s, center[:, None], size[:, None]) < p.neg_iou
        fp_rel = torch.where(far, cand_rel, -1.0)
        fp_j = fp_rel.argmax(dim=1)
        add_neg = new_valid & (fp_rel[ar, fp_j] > p.theta_fp)
        nslot = (st.neg_ptr % p.kn).long()
        neg_set, neg_valid = st.neg_set.clone(), st.neg_valid.clone()
        neg_set[ar, nslot] = torch.where(add_neg[:, None], pats[ar, fp_j],
                                         neg_set[ar, nslot])
        neg_valid[ar, nslot] = torch.where(add_neg, 1.0, neg_valid[ar, nslot])
        st = st._replace(neg_set=neg_set, neg_valid=neg_valid,
                         neg_ptr=st.neg_ptr + add_neg.to(torch.int32))

        # 6. re-anchor the tracker leg on the fused box
        return st._replace(trk=self.mf.set_region(trk2,
                                                  _corners_of(center, size)))

    def corners(self, st: TLDState) -> torch.Tensor:
        return _corners_of(st.center, st.size).transpose(-1, -2)

    def set_region(self, st: TLDState, corners_img, frame=None) -> TLDState:
        corners_img = torch.as_tensor(corners_img, dtype=torch.float32,
                                      device=self.device)
        center, size = _center_size_of(corners_img)
        return st._replace(center=center, size=size,
                           trk=self.mf.set_region(st.trk, corners_img),
                           valid=torch.ones_like(st.valid))

    def reinitialize(self, frame, corners_img) -> TLDState:
        return self.initialize(frame, corners_img)
