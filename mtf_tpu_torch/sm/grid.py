"""Grid trackers (port of `mtf_tpu/sm/grid.py`): `GridTracker`, a
lattice of P small patches, each tracked by a 2-DOF LK flow, fused by a
robust warp fit of any matrix SSM; and `SubTrackerGrid`, a lattice of P
whole sub-trackers (any ported SM, AM and SSM) fused the same way.

Per update and for B trackers at once: the patches are placed by the
flow geometry (`warped`: every point rides the current warp against the
init templates; `rigid`: rigid windows around the predicted centres
against the init templates; `f2f`: rigid windows against templates
resampled from the previous frame); a coarse-to-fine flow over an image
pyramid moves each patch, and RANSAC, LMedS, least squares or the
median-flow similarity (`ops/ransac.py`) over the patch centres fits
the new warp. With `fb_err_px > 0` each patch is tracked back on the
previous frame, and patches whose round trip misses by `fb_err_px`
image pixels or more are left out of the fit (a tracker with fewer
than the minimal sample left keeps them all).

Each pyramid level is one call for all trackers and patches:
  * a dense kind (`interp` "linear_mm", "cubic_mm", "cubic_bspl_mm") on an
    (H, W) frame runs the grid-flow kernel (K5, or K5c with cubic taps)
    on a window per tracker, which runs all of the level's iterations.
    The window is anchored by the grid's own rule,
    clip(floor(min(points)) - 4, 0, size - crop) per axis, once per call
    from the points at the start of the level, as the JAX package's fused
    path (`_track_patches_fused`) does;
  * any other case (`interp` "linear" / "cubic" / "cubic_bspl", or an
    (H, W, C) frame) samples values and gradients by gather on the whole
    level frame each iteration (`interp.sample_val_grad`; a dense kind on
    (H, W, C) goes to `sample_dense` on the whole frame), as the JAX
    package's per-patch path (`_track_patches`) does; no TPU kernel
    stands behind it.

`SubTrackerGrid` runs its B·P sub-trackers as one flat batch of the
sub-tracker's own batched update (tracker-major: sub-tracker b·P + p),
takes the mean of each one's corners as its patch centre, fits the
warp, and re-seats every sub-tracker on the fitted warp.

With `update_multi` each tracker reads its own frame of (B, H, W, C):
per-tracker pyramid levels, K5 windows and gather samples; the
sub-tracker grid's B·P sub-trackers read their parents' B frames by
index (`interp.FrameStack`), with no frame copied per sub-tracker.
The gather kinds take either border (`SMParams.border`); `interp_bf16`
rounds the K5 window's values to bfloat16 and runs K5 with its
bfloat16-weight flag (the JAX package's `_track_patches_mm` with
`compute_dtype=bfloat16`).

The previous frame (f2f, forward-backward) is one (H, W[, C]) copy shared
by the B trackers, owned by the state (a JAX fleet holds B copies), or
the per-tracker frames after an `update_multi`. The
hypothesis draw is a `torch.Generator` on the tracker's device, seeded
from `GridParams.seed` and the update counter `GridState.step`
(`core.seeded_generator`, salt 0); all B
trackers share one draw per update, as all trackers of a JAX fleet share
one key. The counter lives on the host (a 0-d CPU tensor), so seeding
costs no device sync; the draw's bits differ from the JAX package's
threefry bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import ransac
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.kernels.grid_flow import grid_flow
from mtf_tpu_torch.ops.linalg import inv3x3, solve2x2
from mtf_tpu_torch.sm.core import (SearchMethod, TrackerState, image_corners,
                                   is_gray, seeded_generator, tracker_frames)

# the grid window's margin around the point cloud at the start of a level
_GRID_MARGIN = 4.0
FLOWS = ("warped", "rigid", "f2f")


@dataclass(frozen=True)
class GridParams:
    """Reference GridTrackerParams analog (the JAX package's fields)."""
    grid_res: int = 10           # grid_res x grid_res patch centres
    patch_res: int = 8           # patch sampling resolution
    patch_scale: float = 1.0     # patch half-size in centre-spacing units
    sub_iters: int | tuple = 10  # LK iterations per level; a tuple is a
                                 # per-level schedule (0 = full resolution,
                                 # the last entry reused for deeper levels)
    coarse_point_stride: int = 1  # point-grid stride at levels >= 1
    estimator: str = "ransac"    # ransac | lmeds | median | lsq
    n_hyps: int = 64
    inlier_thresh_px: float = 2.0
    fb_err_px: float = -1.0      # forward-backward mask (<= 0: off)
    zncc: bool = True            # standardise patches
    pyramid_levels: int = 2
    flow: str = "warped"         # warped | rigid | f2f
    seed: int = 0


class GridState(NamedTuple):
    """Grid-specific state of B trackers."""
    templates: torch.Tensor    # (B, L, P, n, C) per-level patch templates
    offsets: torch.Tensor      # (B, n, 2) template-frame offsets in a patch
    centers0: torch.Tensor     # (B, P, 2) template-frame patch centres
    step: torch.Tensor         # () int64 on the CPU: updates so far
    inlier_mask: torch.Tensor  # (B, P) last fit's inlier weights
    prev_frame: torch.Tensor | None = None  # (H, W[, C]) the last frame,
                                            # shared, or (B, H, W, C) after
                                            # `update_multi` (f2f or fb only)


def _standardize(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Zero mean, unit (population) std over the point axis -2."""
    mu = p.mean(dim=-2, keepdim=True)
    sd = torch.sqrt(((p - mu) ** 2).mean(dim=-2, keepdim=True))
    return (p - mu) / (sd + eps)


def _level_norm(norm_mat: torch.Tensor, lvl: int) -> torch.Tensor:
    """diag(s, s, 1) @ norm_mat with s = 2^-lvl."""
    s = 1.0 / (2 ** lvl)
    d = torch.tensor([s, s, 1.0], dtype=norm_mat.dtype,
                     device=norm_mat.device)
    return d[:, None] * norm_mat


def _hyp_draw(g: GridParams, ssm, step: int, n_pts: int) -> torch.Tensor:
    """An update's (n_hyps, sample) index draw, shared by the trackers; a
    function of (seed, step) only, on the SSM's device."""
    gen = seeded_generator(g.seed, step, 0, ssm.generators.device)
    return ransac.hyp_indices(gen, g.n_hyps, n_pts,
                              ransac.min_sample_size(ssm))


def _patch_centres(g: GridParams, base_corners: torch.Tensor) -> torch.Tensor:
    """(B, P, 2) template-frame patch centres: a uniform grid strictly
    inside the unit square, mapped through each region's base corners."""
    r = torch.linspace(-0.5, 0.5, g.grid_res + 2, dtype=base_corners.dtype,
                       device=base_corners.device)[1:-1]
    cy, cx = torch.meshgrid(r, r, indexing="ij")
    c_unit = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
    H = W.homography_from_unit_square(base_corners)
    return W.apply_warp(H, c_unit.expand(base_corners.shape[0], -1, -1))


def _per_tracker(img: torch.Tensor, b: int) -> torch.Tensor:
    """A shared frame (H, W[, C]) as B per-tracker frames (B, H, W, C)
    (a view), or per-tracker frames as they are."""
    if img.dim() == 4:
        return img
    return (img[..., None] if img.dim() == 2 else img)[None].expand(
        (b,) + img.shape + ((1,) if img.dim() == 2 else ()))


class GridTracker(SearchMethod):
    """`SearchMethod` over B trackers; `am` is unused (the patch distance
    is SSD, on standardised patches with `zncc`)."""

    name = "grid"

    def __init__(self, am, ssm, prm, grid: GridParams | None = None):
        super().__init__(am, ssm, prm)
        self.grid = g = grid or GridParams()
        if g.flow not in FLOWS:
            raise ValueError(f"GridParams.flow must be one of {FLOWS}, got "
                             f"{g.flow!r}")
        if prm.border not in interp.BORDERS:
            raise ValueError(f"unknown border {prm.border!r}; known: "
                             f"{interp.BORDERS}")
        sel = None
        if g.coarse_point_stride > 1:
            r = np.arange(0, g.patch_res, g.coarse_point_stride)
            sel = torch.as_tensor((r[:, None] * g.patch_res
                                   + r[None, :]).ravel(), device=self.device)
        self.register_buffer("coarse_sel", sel)

    @property
    def keeps_prev_frame(self) -> bool:
        return self.grid.flow == "f2f" or self.grid.fb_err_px > 0

    # -- pyramid and patches ---------------------------------------------
    def _pyr_frames(self, frame: torch.Tensor) -> list:
        """Level 0 = the frame; level l halves it l times with the
        antialiased bilinear resize (what `jax.image.resize(..., "linear")`
        computes), channels resized alike; per-tracker frames
        (B, H, W, C) each resized alike."""
        frames = [frame]
        multi = frame.dim() == 4
        x = (frame.permute(0, 3, 1, 2) if multi else frame[None, None]
             if frame.dim() == 2 else frame.permute(2, 0, 1)[None])
        h, w = x.shape[-2:]
        for lvl in range(1, self.grid.pyramid_levels):
            y = F.interpolate(x, size=(h >> lvl, w >> lvl), mode="bilinear",
                              align_corners=False, antialias=True)
            frames.append(y.permute(0, 2, 3, 1) if multi else y[0, 0]
                          if frame.dim() == 2 else y[0].permute(1, 2, 0))
        return frames

    def _level_iters(self, lvl: int) -> int:
        it = self.grid.sub_iters
        if isinstance(it, (tuple, list)):
            return int(it[min(lvl, len(it) - 1)])
        return int(it)

    def _track_patches(self, frame, norm_l, pts_base, templates, n_iters,
                       crop):
        """One level: pts_base (B, P, n, 2) template-frame points,
        templates (B, P, n, C) -> the (B, P, 2) corrections (template
        units)."""
        kind = self.prm.interp
        if not (kind.endswith(interp.MM_SUFFIX) and is_gray(frame)):
            return self._track_patches_gather(frame, norm_l, pts_base,
                                              templates, n_iters)
        b, P, n, _ = pts_base.shape
        multi = frame.dim() == 4
        h, w = frame.shape[1:3] if multi else frame.shape
        hc, wc = (h, w) if crop is None else (min(crop, h), min(crop, w))
        pts = W.apply_warp(norm_l, pts_base.reshape(b, P * n, 2))
        x0 = self._window_start(pts[..., 0], wc, w)
        y0 = self._window_start(pts[..., 1], hc, h)
        dev = frame.device
        rows = y0.long()[:, None] + torch.arange(hc, device=dev)
        cols = x0.long()[:, None] + torch.arange(wc, device=dev)
        if multi:                                             # (B, hc, wc)
            win = frame[torch.arange(b, device=dev)[:, None, None],
                        rows[:, :, None], cols[:, None, :], 0]
        else:
            win = frame[rows[:, :, None], cols[:, None, :]]
        pts = pts - torch.stack([x0, y0], dim=-1)[:, None]
        flag = {}
        if self.prm.interp_bf16:
            win, flag = interp.round_bf16(win), {"bf16": True}
        return grid_flow(win, pts.transpose(1, 2).contiguous(),
                         templates.reshape(b, P * n).contiguous(),
                         norm_l[:, 0, 0].contiguous(), n, n_iters,
                         zncc=self.grid.zncc,
                         kind=kind[:-len(interp.MM_SUFFIX)], **flag)

    def _window_start(self, v: torch.Tensor, size: int,
                      full: int) -> torch.Tensor:
        """The grid window's start (B,) along one axis from the level's
        point coordinates v (B, M)."""
        return interp.crop_origin(v, size, full, _GRID_MARGIN)

    def _track_patches_gather(self, frame, norm_l, pts_base, templates,
                              n_iters):
        """The per-patch path (`mtf_tpu/sm/grid.py:_track_patches` off the
        dense path): per iteration, every patch's values and gradients by
        gather on the whole level frame, ZNCC, and the damped 2x2 solve
        over its n·C residuals, for all (B, P) patches at once."""
        b, P, n, _ = pts_base.shape
        c = templates.shape[-1]
        scale = norm_l[:, 0, 0][:, None, None, None]
        eye = 1e-6 * torch.eye(2, dtype=frame.dtype, device=frame.device)
        disp = torch.zeros((b, P, 2), dtype=frame.dtype, device=frame.device)
        for _ in range(n_iters):
            pts = W.apply_warp(norm_l, (pts_base + disp[:, :, None]).reshape(
                b, P * n, 2))
            val, grad = interp.sample_val_grad(frame, pts, self.prm.interp,
                                               self.prm.border)
            patch = val.reshape(b, P, n, c)
            if self.grid.zncc:
                patch = _standardize(patch)
            r = (patch - templates).reshape(b, P, n * c, 1)
            J = grad.reshape(b, P, n * c, 2) * scale
            H = J.transpose(-1, -2) @ J + eye
            disp = disp - solve2x2(H, (J.transpose(-1, -2) @ r)[..., 0])
        return disp

    def _track_patches_pyr(self, frames, norm_mat, pts_base, templates):
        """Coarse-to-fine flow over the level frames `frames`; returns the
        accumulated (B, P, 2) corrections in the template frame."""
        g = self.grid
        disp = torch.zeros(pts_base.shape[:2] + (2,), dtype=frames[0].dtype,
                           device=frames[0].device)
        c0 = self.prm.crop
        for lvl in reversed(range(g.pyramid_levels)):
            crop = None if c0 is None else (
                c0 if lvl == 0 else max(48, (c0 >> lvl) + 16))
            # levels >= 1 may run on the stride-decimated point grid
            sel = self.coarse_sel if lvl else None
            tm = templates[:, lvl]
            pb = pts_base
            if sel is not None:
                pb, tm = pts_base[:, :, sel], tm[:, :, sel]
                if g.zncc:
                    # the live patch is standardised over the subset, so
                    # the subset template is re-standardised to match
                    tm = _standardize(tm)
            disp = disp + self._track_patches(
                frames[lvl], _level_norm(norm_mat, lvl),
                pb + disp[:, :, None, :], tm, self._level_iters(lvl), crop)
        return disp

    def _templates_at(self, frames, norm_mat, centers, offsets):
        """(B, L, P, n, C) per-level patch templates around `centers`,
        sampled from the level frames `frames`."""
        g = self.grid
        pts_t = centers[:, :, None, :] + offsets[:, None]      # (B, P, n, 2)
        b, P, n, _ = pts_t.shape
        out = []
        for lvl, frm in enumerate(frames):
            pts = W.apply_warp(_level_norm(norm_mat, lvl),
                               pts_t.reshape(b, P * n, 2))
            p = interp.sample(frm, pts, self.prm.interp,
                              self.prm.border).reshape(b, P, n, -1)
            out.append(_standardize(p) if g.zncc else p)
        return torch.stack(out, dim=1)

    # -- SearchMethod hooks ----------------------------------------------
    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        g = self.grid
        region = state.region
        b = region.norm_mat.shape[0]
        dev, dt = frame.device, frame.dtype
        centers0 = _patch_centres(g, region.base_corners)
        half = g.patch_scale / (g.grid_res + 1)
        o = torch.linspace(-half, half, g.patch_res, dtype=dt, device=dev)
        oy, ox = torch.meshgrid(o, o, indexing="ij")
        offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)],
                              dim=-1).expand(b, -1, -1).contiguous()
        return GridState(
            templates=self._templates_at(self._pyr_frames(frame),
                                         region.norm_mat, centers0, offsets),
            offsets=offsets, centers0=centers0,
            step=torch.zeros((), dtype=torch.int64),
            inlier_mask=torch.ones(centers0.shape[:2], dtype=dt, device=dev),
            prev_frame=frame.clone() if self.keeps_prev_frame else None)

    def _hyp_indices(self, step: int, n_pts: int) -> torch.Tensor:
        return _hyp_draw(self.grid, self.ssm, step, n_pts)

    def _patch_points(self, state: TrackerState):
        """(the predicted centres (B, P, 2), the patches' template-frame
        points (B, P, n, 2)) at the current warp."""
        gs: GridState = state.extra
        M = self.ssm.to_matrix(state.ssm_state)
        centers_pred = W.apply_warp(M, gs.centers0)
        b, P, _ = gs.centers0.shape
        n = gs.offsets.shape[1]
        if self.grid.flow == "warped":
            # chained-warp patches: every point rides the global warp, so
            # the init templates stay geometrically valid
            return centers_pred, W.apply_warp(
                M, (gs.centers0[:, :, None, :] + gs.offsets[:, None]).reshape(
                    b, P * n, 2)).reshape(b, P, n, 2)
        return centers_pred, centers_pred[:, :, None, :] + gs.offsets[:, None]

    def _update_multi(self, state: TrackerState, frames) -> TrackerState:
        # every step below reads per-tracker frames (B, H, W, C) as such
        return self._update(state, tracker_frames(frames))

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        g = self.grid
        gs: GridState = state.extra
        region = state.region
        centers_pred, pts_base = self._patch_points(state)
        prev = gs.prev_frame
        if prev is not None and (prev.dim() == 4) != (frame.dim() == 4):
            # per-tracker frames after a shared one, or the other way
            b = region.norm_mat.shape[0]
            prev, frame = _per_tracker(prev, b), _per_tracker(frame, b)
        frames = self._pyr_frames(frame)
        prev_frames = None if prev is None else self._pyr_frames(prev)
        templates = gs.templates
        if g.flow == "f2f" and prev is not None:
            # templates from the previous frame at the predicted centres
            # (GridTrackerCV's pyramidal LK, prev -> cur)
            templates = self._templates_at(prev_frames, region.norm_mat,
                                           centers_pred, gs.offsets)
        disp = self._track_patches_pyr(frames, region.norm_mat, pts_base,
                                       templates)
        centers_new = centers_pred + disp
        weights = None
        if g.fb_err_px > 0 and prev is not None:
            # track back on the previous frame; a large round trip marks
            # an unreliable patch
            back = (self._templates_at(frames, region.norm_mat, centers_new,
                                       gs.offsets)
                    if g.flow == "f2f" else gs.templates)
            disp_back = self._track_patches_pyr(
                prev_frames, region.norm_mat, pts_base + disp[:, :, None],
                back)
            fb = torch.linalg.vector_norm(disp + disp_back, dim=-1) \
                * region.norm_mat[:, 0, 0, None]
            weights = (fb < g.fb_err_px).to(frame.dtype)
            # per tracker: too few reliable patches keep them all
            enough = weights.sum(-1, keepdim=True) \
                >= ransac.min_sample_size(self.ssm)
            weights = torch.where(enough, weights, torch.ones_like(weights))
        new_ssm, inl = self._fit_warp(region, gs.centers0, centers_new,
                                      int(gs.step), weights)
        return state._replace(ssm_state=new_ssm, extra=gs._replace(
            step=gs.step + 1, inlier_mask=inl,
            prev_frame=frame.clone() if self.keeps_prev_frame else None))

    def _fit_warp(self, region, centers0, centers_new, step: int,
                  weights=None):
        """Robust warp fit from the patch correspondences; the inlier
        threshold is `inlier_thresh_px` in each tracker's template units;
        `weights` (B, P) the forward-backward mask."""
        g = self.grid
        idx = None
        if g.estimator in ransac.SAMPLED:
            idx = self._my_hyps(self._hyp_indices(step, centers0.shape[1]))
        return ransac.robust_fit(
            self.ssm, centers0, centers_new, idx, method=g.estimator,
            inlier_thresh=g.inlier_thresh_px / region.norm_mat[:, 0, 0],
            weights=weights, select=self._select_hyp)

    # -- the hypotheses: all of them here; `ShardedGridTracker` scores its
    # rank's and picks among every rank's best
    _select_hyp = None

    def _my_hyps(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the (H, sample) hypothesis draw."""
        return idx


class SubGridState(NamedTuple):
    """SubTrackerGrid-specific state of B trackers of P sub-trackers."""
    sub_states: TrackerState   # the B·P sub-trackers' state, one flat
                               # batch, tracker-major (b·P + p)
    centers0: torch.Tensor     # (B, P, 2) template-frame patch centres
    half_img: torch.Tensor     # (B,) patch half-size in image pixels
    step: torch.Tensor         # () int64 on the CPU: updates so far
    inlier_mask: torch.Tensor  # (B, P) last fit's inlier weights


class SubTrackerGrid(SearchMethod):
    """Grid of whole sub-trackers fused by a robust warp fit (the
    reference's general GridTracker: any `grid_sm` x `grid_am` x `grid_ssm`
    per patch). The B·P sub-trackers are one batch of `sub`'s own update;
    the fit's hypothesis draw is the grid's (`GridParams.seed`, the update
    counter)."""

    name = "grid_sub"

    def __init__(self, sub: SearchMethod, ssm, prm=None,
                 grid: GridParams | None = None):
        super().__init__(sub.am, ssm, prm)
        self.sub = sub
        self.grid = grid or GridParams()

    @staticmethod
    def _patch_corners_img(norm_mat, centers_t, half_img):
        """(B, P, 4, 2) image corner squares of half-size `half_img` (B,)
        around the centres (B, P, 2)."""
        c_img = W.apply_warp(norm_mat, centers_t)
        offs = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0],
                             [-1.0, 1.0]], dtype=c_img.dtype,
                            device=c_img.device)
        return c_img[:, :, None, :] + half_img[:, None, None, None] * offs

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        g = self.grid
        region = state.region
        centers0 = _patch_centres(g, region.base_corners)
        b, P, _ = centers0.shape
        half_img = g.patch_scale / (g.grid_res + 1) * region.norm_mat[:, 0, 0]
        corners = self._patch_corners_img(region.norm_mat, centers0,
                                          half_img)
        return SubGridState(
            sub_states=self.sub.initialize(frame,
                                           corners.reshape(b * P, 4, 2)),
            centers0=centers0, half_img=half_img,
            step=torch.zeros((), dtype=torch.int64),
            inlier_mask=torch.ones((b, P), dtype=frame.dtype,
                                   device=frame.device))

    def _hyp_indices(self, step: int, n_pts: int) -> torch.Tensor:
        return _hyp_draw(self.grid, self.ssm, step, n_pts)

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        return self._step(state, self.sub.update(state.extra.sub_states,
                                                 frame))

    def _update_multi(self, state: TrackerState, frames) -> TrackerState:
        """Each tracker's P sub-trackers on its own frame: one
        `update_multi` of the B·P sub-trackers, sub-tracker b·P + p
        reading frame b by index (`FrameStack`: no frame is copied per
        sub-tracker)."""
        frames = tracker_frames(frames)
        P = state.extra.centers0.shape[1]
        stack = interp.FrameStack(frames, torch.arange(
            frames.shape[0], device=frames.device).repeat_interleave(P))
        sub, st = self.sub, state.extra.sub_states
        return self._step(state, sub._update_multi(st, stack)
                          if isinstance(sub, SearchMethod)
                          else sub.update_multi(st, tracker_frames(stack)))

    def _step(self, state: TrackerState, sub_states) -> TrackerState:
        """The fit and re-seat after the sub-trackers' update."""
        g = self.grid
        gs: SubGridState = state.extra
        region = state.region
        b, P, _ = gs.centers0.shape
        # patch centres: the mean of each sub-tracker's corners, pulled
        # back into the template frame for the fit
        centers_img = image_corners(self.sub.ssm, sub_states).reshape(
            b, P, 4, 2).mean(-2)
        centers_t = W.apply_warp(inv3x3(region.norm_mat), centers_img)
        idx = (self._hyp_indices(int(gs.step), P)
               if g.estimator in ransac.SAMPLED else None)
        new_ssm, inl = ransac.robust_fit(
            self.ssm, gs.centers0, centers_t, idx, method=g.estimator,
            inlier_thresh=g.inlier_thresh_px / region.norm_mat[:, 0, 0])
        # re-seat every sub-tracker on the fitted warp (reset to the SSM,
        # GridTracker.cc:294+), which stops them drifting apart
        corners = self._patch_corners_img(
            region.norm_mat, self.ssm.warp_pts(new_ssm, gs.centers0),
            gs.half_img)
        sub_states = self.sub.set_region(sub_states,
                                         corners.reshape(b * P, 4, 2))
        return state._replace(ssm_state=new_ssm, extra=gs._replace(
            sub_states=sub_states, step=gs.step + 1, inlier_mask=inl))
