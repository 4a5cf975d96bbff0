"""Grid tracker (port of `mtf_tpu/sm/grid.py:GridTracker`, the "warped"
flow): a lattice of P small patches, each tracked by a 2-DOF LK flow
through the current global warp, fused by a robust homography fit.

Per update and for B trackers at once: every patch's points ride the
current warp; a coarse-to-fine flow over a 2-level image pyramid moves
each patch (one call of the grid-flow kernel K5 per level, which runs all
of that level's iterations), and RANSAC (or LMedS, or least squares) over
the patch centres fits the new warp (`ops/ransac.py`).

The window of each level call is anchored by the grid's own rule,
clip(floor(min(points)) - 4, 0, size - crop) per axis, computed once per
call from the points at the start of the level, as the JAX package's
fused path (`_track_patches_fused`) does.

The hypothesis draw is a `torch.Generator` on the tracker's device,
seeded from `GridParams.seed` and the update counter `GridState.step`;
all B trackers share one draw per update, as all trackers of a JAX fleet
share one key. The counter lives on the host (a 0-d CPU tensor), so
seeding costs no device sync; the draw's bits differ from the JAX
package's threefry bits.
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
from mtf_tpu_torch.sm.core import SearchMethod, TrackerState
from mtf_tpu_torch.ssm.projective import Homography

# the grid window's margin around the point cloud at the start of a level
_GRID_MARGIN = 4.0


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
    estimator: str = "ransac"    # ransac | lmeds | lsq
    n_hyps: int = 64
    inlier_thresh_px: float = 2.0
    fb_err_px: float = -1.0      # forward-backward mask (<= 0: off)
    zncc: bool = True            # standardise patches
    pyramid_levels: int = 2
    flow: str = "warped"         # only "warped" is ported
    seed: int = 0


class GridState(NamedTuple):
    """Grid-specific state of B trackers."""
    templates: torch.Tensor    # (B, L, P, n, 1) per-level patch templates
    offsets: torch.Tensor      # (B, n, 2) template-frame offsets in a patch
    centers0: torch.Tensor     # (B, P, 2) template-frame patch centres
    step: torch.Tensor         # () int64 on the CPU: updates so far
    inlier_mask: torch.Tensor  # (B, P) last fit's inlier weights


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


class GridTracker(SearchMethod):
    """`SearchMethod` over B trackers; `am` is unused (the patch distance
    is SSD, on standardised patches with `zncc`)."""

    name = "grid"

    def __init__(self, am, ssm, prm, grid: GridParams | None = None):
        super().__init__(am, ssm, prm)
        self.grid = g = grid or GridParams()
        queue = {
            "flow 'warped'": (g.flow == "warped", "Queue 1c"),
            "fb_err_px <= 0": (g.fb_err_px <= 0, "Queue 1c"),
            "interp 'linear_mm'": (prm.interp == "linear_mm", "Queue 1c"),
            "border 'replicate'": (prm.border == "replicate",
                                   "Queue 1, slice 8"),
            "ssm '8'": (isinstance(ssm, Homography), "Queue 1, slice 4"),
        }
        missing = [(k, q) for k, (ok, q) in queue.items() if not ok]
        if missing:
            raise NotImplementedError(
                f"GridTracker is ported for {', '.join(queue)} only; this "
                "configuration lacks "
                + ", ".join(f"{k} (ROADMAP {q})" for k, q in missing))
        sel = None
        if g.coarse_point_stride > 1:
            r = np.arange(0, g.patch_res, g.coarse_point_stride)
            sel = torch.as_tensor((r[:, None] * g.patch_res
                                   + r[None, :]).ravel(), device=self.device)
        self.register_buffer("coarse_sel", sel)

    # -- pyramid and patches ---------------------------------------------
    def _pyr_frames(self, frame: torch.Tensor) -> list:
        """Level 0 = the frame; level l halves it l times with the
        antialiased bilinear resize (what `jax.image.resize(..., "linear")`
        computes)."""
        frames = [frame]
        for lvl in range(1, self.grid.pyramid_levels):
            size = (frame.shape[0] >> lvl, frame.shape[1] >> lvl)
            frames.append(F.interpolate(
                frame[None, None], size=size, mode="bilinear",
                align_corners=False, antialias=True)[0, 0])
        return frames

    def _level_iters(self, lvl: int) -> int:
        it = self.grid.sub_iters
        if isinstance(it, (tuple, list)):
            return int(it[min(lvl, len(it) - 1)])
        return int(it)

    def _track_patches(self, frame, norm_l, pts_base, templates, n_iters,
                       crop):
        """One level: pts_base (B, P, n, 2) template-frame points,
        templates (B, P, n, 1) -> the (B, P, 2) corrections (template
        units), by one grid-flow call on a window per tracker."""
        b, P, n, _ = pts_base.shape
        h, w = frame.shape
        hc, wc = (h, w) if crop is None else (min(crop, h), min(crop, w))
        pts = W.apply_warp(norm_l, pts_base.reshape(b, P * n, 2))
        x0 = interp.crop_origin(pts[..., 0], wc, w, _GRID_MARGIN)
        y0 = interp.crop_origin(pts[..., 1], hc, h, _GRID_MARGIN)
        dev = frame.device
        rows = y0.long()[:, None] + torch.arange(hc, device=dev)
        cols = x0.long()[:, None] + torch.arange(wc, device=dev)
        win = frame[rows[:, :, None], cols[:, None, :]]       # (B, hc, wc)
        pts = pts - torch.stack([x0, y0], dim=-1)[:, None]
        return grid_flow(win, pts.transpose(1, 2).contiguous(),
                         templates.reshape(b, P * n).contiguous(),
                         norm_l[:, 0, 0].contiguous(), n, n_iters,
                         zncc=self.grid.zncc)

    def _track_patches_pyr(self, frame, norm_mat, pts_base, templates):
        """Coarse-to-fine flow; returns the accumulated (B, P, 2)
        corrections in the template frame."""
        g = self.grid
        frames = self._pyr_frames(frame)
        disp = torch.zeros(pts_base.shape[:2] + (2,), dtype=frame.dtype,
                           device=frame.device)
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

    def _templates_at(self, frame, norm_mat, centers, offsets):
        """(B, L, P, n, 1) per-level patch templates around `centers`."""
        g = self.grid
        pts_t = centers[:, :, None, :] + offsets[:, None]      # (B, P, n, 2)
        b, P, n, _ = pts_t.shape
        out = []
        for lvl, frm in enumerate(self._pyr_frames(frame)):
            pts = W.apply_warp(_level_norm(norm_mat, lvl),
                               pts_t.reshape(b, P * n, 2))
            p = interp.sample(frm, pts, self.prm.interp,
                              self.prm.border).reshape(b, P, n, 1)
            out.append(_standardize(p) if g.zncc else p)
        return torch.stack(out, dim=1)

    # -- SearchMethod hooks ----------------------------------------------
    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        if frame.dim() != 2:
            raise NotImplementedError(
                "multi-channel frames come with ROADMAP Queue 1, slice 4")
        g = self.grid
        region = state.region
        b = region.norm_mat.shape[0]
        dev, dt = frame.device, frame.dtype
        # patch centres: a uniform grid strictly inside the unit square,
        # mapped through each region's base corners
        r = torch.linspace(-0.5, 0.5, g.grid_res + 2, dtype=dt,
                           device=dev)[1:-1]
        cy, cx = torch.meshgrid(r, r, indexing="ij")
        c_unit = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
        H = W.homography_from_unit_square(region.base_corners)
        centers0 = W.apply_warp(H, c_unit.expand(b, -1, -1))  # (B, P, 2)
        half = g.patch_scale / (g.grid_res + 1)
        o = torch.linspace(-half, half, g.patch_res, dtype=dt, device=dev)
        oy, ox = torch.meshgrid(o, o, indexing="ij")
        offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)],
                              dim=-1).expand(b, -1, -1).contiguous()
        return GridState(
            templates=self._templates_at(frame, region.norm_mat, centers0,
                                         offsets),
            offsets=offsets, centers0=centers0,
            step=torch.zeros((), dtype=torch.int64),
            inlier_mask=torch.ones(centers0.shape[:2], dtype=dt, device=dev))

    def _hyp_indices(self, step: int, n_pts: int) -> torch.Tensor:
        """This update's (n_hyps, sample) index draw, shared by the
        trackers; a function of (seed, step) only."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.grid.seed & 0x7FFFFFFF) << 32) + step)
        return ransac.hyp_indices(gen, self.grid.n_hyps, n_pts,
                                  ransac.min_sample_size(self.ssm))

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        gs: GridState = state.extra
        region, ssm = state.region, self.ssm
        M = ssm.to_matrix(state.ssm_state)
        centers_pred = W.apply_warp(M, gs.centers0)
        # chained-warp patches: every point rides the global warp, so the
        # init templates stay geometrically valid
        b, P, _ = gs.centers0.shape
        n = gs.offsets.shape[1]
        pts_base = W.apply_warp(
            M, (gs.centers0[:, :, None, :] + gs.offsets[:, None]).reshape(
                b, P * n, 2)).reshape(b, P, n, 2)
        disp = self._track_patches_pyr(frame, region.norm_mat, pts_base,
                                       gs.templates)
        new_ssm, inl = self._fit_warp(region, gs.centers0,
                                      centers_pred + disp, int(gs.step))
        return state._replace(ssm_state=new_ssm, extra=gs._replace(
            step=gs.step + 1, inlier_mask=inl))

    def _fit_warp(self, region, centers0, centers_new, step: int):
        """Robust warp fit from the patch correspondences; the inlier
        threshold is `inlier_thresh_px` in each tracker's template units."""
        g = self.grid
        idx = None
        if g.estimator in ("ransac", "lmeds", "least_median"):
            idx = self._hyp_indices(step, centers0.shape[1])
        return ransac.robust_fit(
            self.ssm, centers0, centers_new, idx, method=g.estimator,
            inlier_thresh=g.inlier_thresh_px / region.norm_mat[:, 0, 0])
