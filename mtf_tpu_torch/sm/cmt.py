"""CMT, Consensus-based Matching and Tracking (port of `mtf_tpu/sm/cmt.py`;
Nebehay & Pflugfelder, CVPR'15), over B trackers.

A database of target keypoints with positions relative to the object
center is (a) tracked frame to frame by pyramidal Lucas-Kanade with a
forward-backward gate and (b) re-matched against fresh detections; the
scale and rotation come from median votes over keypoint pairs, each
keypoint then votes for the center, and the cluster of votes around their
per-axis median places the target.

Batched as one program over the B trackers: the K keypoints of every
tracker are tracked in one loop of fixed counts (levels x iterations, the
2x2 solves in closed form), the pairwise scale and rotation estimates are
(B, K, K) masked tensors and their medians masked sorts (the lower
median, as the JAX package takes it). OpenCV detects once per frame on
the host, and the B trackers share those detections and one copy of the
previous frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.sm.cf import BoxTracker, _center_size_of
from mtf_tpu_torch.sm.core import multi_unported
from mtf_tpu_torch.sm.feature import (_descr_float, _make_descriptor,
                                      _make_detector, _to_u8)
from mtf_tpu_torch.sm.lk import _blur2


@dataclass(frozen=True)
class CMTParams:
    """CMT.cpp's defaults: the keypoint budget, thr_ratio 0.8, a 20-px
    consensus cluster cutoff, the forward-backward gate."""
    detector: str = "orb"
    max_keypoints: int = 128   # foreground keypoint slots (K)
    max_bg: int = 256          # background descriptor slots
    ratio_thresh: float = 0.8
    match_thresh: float = 0.25  # max normalised descriptor distance
    fb_err: float = 2.0        # forward-backward gate (px)
    lk_res: int = 9            # LK patch size per keypoint
    lk_iters: int = 12
    lk_levels: int = 2
    consensus_radius: float = 20.0  # vote cluster radius (thr_outlier)
    min_votes: int = 4
    seed: int = 0


class CMTState(NamedTuple):
    center: torch.Tensor      # (B, 2)
    scale: torch.Tensor       # (B,)
    rot: torch.Tensor         # (B,) radians
    base_sz: torch.Tensor     # (B, 2) init box size
    kp_rel: torch.Tensor      # (B, K, 2) init positions relative to center
    kp_desc: torch.Tensor     # (B, K, D) foreground descriptors
    kp_valid: torch.Tensor    # (B, K) float 0/1
    bg_desc: torch.Tensor     # (B, KB, D) background descriptors
    bg_valid: torch.Tensor    # (B, KB) float 0/1
    active_pos: torch.Tensor  # (B, K, 2) tracked keypoint positions
    active_ok: torch.Tensor   # (B, K) bool: tracked this frame
    prev_frame: torch.Tensor  # (H, W) the previous gray frame, one copy
                              # shared by the B trackers


def _pad(a: np.ndarray, n: int, d: int | None = None):
    """Rows of `a` zero-padded (or cut) to (n, d) and their validity
    (n,) as float 0/1."""
    d = a.shape[1] if d is None else d
    out = np.zeros((n, d), np.float32)
    k = min(len(a), n)
    if k:
        out[:k] = a[:k, :d]
    valid = np.zeros((n,), np.float32)
    valid[:k] = 1.0
    return out, valid


def _rot_mats(rot: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(rot), torch.sin(rot)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)                                      # (B, 2, 2)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The lower median of each row of x (B, M) over `mask` (the JAX
    package's sort-based one; `torch.median` of the masked entries is
    not the same where none is masked)."""
    big = x.abs().amax(-1, keepdim=True) + 1.0
    xs = torch.sort(torch.where(mask, x, big), dim=-1).values
    n = mask.sum(-1, keepdim=True)
    mid = torch.clamp(n - 1, min=0) // 2
    return torch.gather(xs, -1, mid)[..., 0]


class CMT(BoxTracker):
    """The 'cmt' key: a similarity box (center, scale, rotation)."""

    name = "cmt"

    def __init__(self, prm: CMTParams | None = None, device=None):
        super().__init__(device)
        self.prm = prm or CMTParams()
        n = self.prm.max_keypoints + self.prm.max_bg
        self._detector = _make_detector(self.prm.detector, n)
        self._descriptor = _make_descriptor(self.prm.detector, n)

    # -- host detection (the reference uses BRISK detect/compute) ----------
    def _detect(self, frame):
        img = _to_u8(frame)
        kps = self._detector.detect(img, None)
        kps, desc = self._descriptor.compute(img, kps)
        if not kps:
            return np.zeros((0, 2), np.float32), np.zeros((0, 1), np.float32)
        pts = np.asarray([k.pt for k in kps], np.float32)
        return pts, _descr_float(desc)

    def _gray(self, frame) -> torch.Tensor:
        frame = self._frame(frame)
        return frame.mean(-1) if frame.dim() == 3 else frame

    # -- pyramidal LK over every keypoint (Tracker::track) -----------------
    def _lk_points(self, prev, curr, pts, valid):
        """Track points (B, K, 2) from prev to curr -> (new points, ok):
        12 iterations at each of 2 levels, forward then backward, gated by
        the forward-backward error. The coarse levels sample binomially
        blurred images (`_blur2`; a strided sample of the raw image
        aliases past thin gradient structure)."""
        p = self.prm
        r = p.lk_res // 2
        dg = torch.arange(-r, r + 1, dtype=torch.float32, device=pts.device)
        gy, gx = torch.meshgrid(dg, dg, indexing="ij")
        offs = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # (P, 2)
        scales = [2 ** lvl for lvl in range(p.lk_levels - 1, -1, -1)]
        prev_l = {s: _blur2(prev, s) for s in scales}
        curr_l = {s: _blur2(curr, s) for s in scales}
        eye = 1e-4 * torch.eye(2, device=pts.device)

        def track(imgs0, imgs1, pt):
            shift = torch.zeros_like(pt)
            for s in scales:
                o = offs * float(s)
                t = interp.sample(imgs0[s], pt[..., None, :] + o,
                                  "linear")[..., 0]             # (B, K, P)
                for _ in range(p.lk_iters):
                    q = pt[..., None, :] + shift[..., None, :] + o
                    v, g = interp.sample_val_grad(imgs1[s], q, "linear")
                    g = g[..., 0, :]                             # (B, K, P, 2)
                    rvec = v[..., 0] - t
                    H = g.transpose(-1, -2) @ g + eye             # (B, K, 2, 2)
                    rhs = (g.transpose(-1, -2) @ rvec[..., None])[..., 0]
                    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
                    dx = (H[..., 1, 1] * rhs[..., 0] - H[..., 0, 1] * rhs[..., 1])
                    dy = (H[..., 0, 0] * rhs[..., 1] - H[..., 1, 0] * rhs[..., 0])
                    shift = shift - torch.stack([dx, dy], -1) / det[..., None]
            return pt + shift

        fwd = track(prev_l, curr_l, pts)
        bwd = track(curr_l, prev_l, fwd)
        fb = torch.linalg.vector_norm(bwd - pts, dim=-1)
        return fwd, (fb < p.fb_err) & (valid > 0.5)

    # -- matching (Matcher::matchGlobal) -------------------------------------
    def _match(self, state: CMTState, pts, desc, dvalid):
        """Match one frame's detections pts (N, 2), desc (N, D), dvalid
        (N,) to each foreground database with a ratio test against both
        the second-best foreground and the best background descriptor.
        -> per database slot (positions (B, K, 2), ok (B, K))."""
        p = self.prm

        def dist(a, b):
            # binary rows as {0, 1}: Hamming = |a| + |b| - 2ab, normalised
            # by the dimension
            d = (a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :]
                 - 2.0 * torch.matmul(a, b.transpose(-1, -2)))
            return d / a.shape[-1]

        dv = dvalid[:, None] > 0.5
        dfg = torch.where(dv & (state.kp_valid[:, None, :] > 0.5),
                          dist(desc, state.kp_desc), 1e3)         # (B, N, K)
        dbg = torch.where(dv & (state.bg_valid[:, None, :] > 0.5),
                          dist(desc, state.bg_desc), 1e3)
        best_bg = dbg.amin(-1)                                    # (B, N)
        # per database slot: its best detection, then the second best of
        # the same column
        j = torch.argmin(dfg, dim=-2)                             # (B, K)
        dbest = dfg.amin(-2)
        dfg2 = dfg.scatter(-2, j[:, None, :], 1e3)
        dsecond = torch.minimum(dfg2, best_bg[..., None]).amin(-2)
        ok = ((dbest < p.match_thresh) & (dbest < p.ratio_thresh * dsecond)
              & (state.kp_valid > 0.5))
        return pts[j], ok

    # -- consensus (estimateScaleRotation, findConsensus) --------------------
    def _consensus(self, pos, ok, rel):
        """(center (B, 2), scale (B,), rotation (B,), inliers (B, K)) from
        the keypoints' votes."""
        p = self.prm
        k = pos.shape[1]
        ar = torch.arange(k, device=pos.device)
        pair = ok[:, :, None] & ok[:, None, :] & (ar[:, None] < ar[None, :])
        dp = pos[:, :, None, :] - pos[:, None, :, :]
        dr = rel[:, :, None, :] - rel[:, None, :, :]
        ndp = torch.linalg.vector_norm(dp, dim=-1)
        ndr = torch.linalg.vector_norm(dr, dim=-1)
        pair = pair & (ndr > 1e-3)
        s = _masked_median((ndp / torch.clamp(ndr, min=1e-6)).flatten(1),
                           pair.flatten(1))
        # the rotation: the resultant-vector mean of the pairs' angle
        # differences (the JAX package's live estimate)
        ang = (torch.atan2(dp[..., 1], dp[..., 0])
               - torch.atan2(dr[..., 1], dr[..., 0]))
        w = pair.to(torch.float32)
        rot = torch.atan2((torch.sin(ang) * w).sum((1, 2)) + 1e-12,
                          (torch.cos(ang) * w).sum((1, 2)) + 1e-12)
        votes = pos - s[:, None, None] * (rel @ _rot_mats(rot).transpose(-1, -2))
        # the vote cluster: start at the per-axis median, keep the votes
        # within the radius, refine by their mean
        center = torch.stack([_masked_median(votes[..., 0], ok),
                              _masked_median(votes[..., 1], ok)], -1)
        for _ in range(2):
            d = torch.linalg.vector_norm(votes - center[:, None], dim=-1)
            inl = ok & (d < p.consensus_radius)
            wsum = torch.clamp(inl.sum(-1).to(torch.float32), min=1.0)
            center = torch.where(inl[..., None], votes, 0.0).sum(1) \
                / wsum[:, None]
        d = torch.linalg.vector_norm(votes - center[:, None], dim=-1)
        return center, s, rot, ok & (d < p.consensus_radius)

    # -- the tracker contract -------------------------------------------------
    def initialize(self, frame, corners_img) -> CMTState:
        """B trackers on one frame from corners (B, 4, 2): one detection
        of the frame, split by each box into foreground and background."""
        p = self.prm
        gray = self._gray(frame)
        corners = self._corners_in(corners_img)
        center, size = _center_size_of(corners)
        c_np, s_np = center.cpu().numpy(), size.cpu().numpy()
        pts, desc = self._detect(gray)
        fg_p, fg_v, fg_d, bg_d, bg_v = [], [], [], [], []
        for b in range(len(c_np)):
            pb, db = pts, desc
            if len(pb) == 0:
                pb, db = c_np[b][None, :], np.zeros((1, 8), np.float32)
            inside = (np.abs(pb - c_np[b]) <= s_np[b] / 2).all(axis=1)
            D = db.shape[1]
            a, v = _pad(pb[inside], p.max_keypoints, 2)
            fg_p.append(a)
            fg_v.append(v)
            fg_d.append(_pad(db[inside], p.max_keypoints, D)[0])
            a, v = _pad(db[~inside], p.max_bg, D)
            bg_d.append(a)
            bg_v.append(v)

        def dev(xs):
            return torch.as_tensor(np.stack(xs), device=self.device)

        fg_p, fg_v = dev(fg_p), dev(fg_v)
        b = center.shape[0]
        return CMTState(
            center=center, scale=torch.ones((b,), device=self.device),
            rot=torch.zeros((b,), device=self.device), base_sz=size,
            kp_rel=fg_p - center[:, None, :], kp_desc=dev(fg_d),
            kp_valid=fg_v, bg_desc=dev(bg_d), bg_valid=dev(bg_v),
            active_pos=fg_p, active_ok=fg_v > 0.5, prev_frame=gray)

    def update_with_detections(self, state: CMTState, pts, desc, dvalid,
                               frame) -> CMTState:
        """The device stage on one frame's padded detections pts (N, 2),
        desc (N, D), dvalid (N,) and the gray frame (H, W): LK-track,
        match, consensus, fuse."""
        # 1. frame-to-frame LK on the active keypoints
        trk_pos, trk_ok = self._lk_points(state.prev_frame, frame,
                                          state.active_pos,
                                          state.active_ok.to(torch.float32))
        # 2. global matching of the fresh detections
        m_pos, m_ok = self._match(state, pts, desc, dvalid)
        # 3. fuse: a tracked position wins, matches revive lost keypoints
        pos = torch.where(trk_ok[..., None], trk_pos, m_pos)
        ok = trk_ok | m_ok
        # 4. scale and rotation, then the center consensus
        center, s, rot, inl = self._consensus(pos, ok, state.kp_rel)
        enough = inl.sum(-1) >= self.prm.min_votes
        center = torch.where(enough[:, None], center, state.center)
        s = torch.where(enough, s, state.scale)
        rot = torch.where(enough, rot, state.rot)
        # 5. survivors stay active; lost keypoints re-seed where the
        # consensus expects them (so LK can pick them back up)
        expected = center[:, None, :] + s[:, None, None] * (
            state.kp_rel @ _rot_mats(rot).transpose(-1, -2))
        new_pos = torch.where(inl[..., None], pos, expected)
        return state._replace(center=center, scale=s, rot=rot,
                              active_pos=new_pos,
                              active_ok=inl | (state.kp_valid > 0.5),
                              prev_frame=frame)

    def update(self, state: CMTState, frame) -> CMTState:
        p = self.prm
        gray = self._gray(frame)
        pts, desc = self._detect(gray)
        n = p.max_keypoints + p.max_bg
        pt_p, pt_v = _pad(pts, n, 2)
        de_p, _ = _pad(desc, n, state.kp_desc.shape[-1])
        dev = self.device
        return self.update_with_detections(
            state, torch.as_tensor(pt_p, device=dev),
            torch.as_tensor(de_p, device=dev),
            torch.as_tensor(pt_v, device=dev), gray)

    def update_multi(self, state, frames):
        raise multi_unported(self)

    def corners(self, st: CMTState) -> torch.Tensor:
        """(B, 2, 4) corners of the scaled and rotated init boxes."""
        w, h = st.base_sz[:, 0] / 2, st.base_sz[:, 1] / 2
        base = torch.stack([torch.stack([-w, -h], -1), torch.stack([w, -h], -1),
                            torch.stack([w, h], -1), torch.stack([-w, h], -1)],
                           1)                                     # (B, 4, 2)
        out = st.center[:, None, :] + st.scale[:, None, None] * (
            base @ _rot_mats(st.rot).transpose(-1, -2))
        return out.transpose(-1, -2)

    def set_region(self, st: CMTState, corners_img, frame=None) -> CMTState:
        center, size = _center_size_of(self._corners_in(corners_img))
        scale = (size / torch.clamp(st.base_sz, min=1e-6)).mean(-1)
        return st._replace(center=center, scale=scale)
