"""Composite search methods (port of `mtf_tpu/sm/composite.py`), over a
leading batch of B trackers: `CascadeSM`, `ParallelSM`, `PyramidalSM`
and RKLT.

  * CascadeSM: member k starts from member k-1's corners; with
    `auto_reinit_thresh`, a member whose corners leave its starting
    corners by more than that many pixels is reset to them.
  * ParallelSM: the members step side by side; the estimate is the mean
    of their corners, to which every member is reset (`reset_to_mean`).
  * PyramidalSM: one SM with a state per level of a Gaussian pyramid
    (`utils/pyramid.py`), stepped coarse to fine, corners scaled by
    2^level between levels.
  * RKLT: the grid localizer with a template refiner and failure fallback
    (reference NT/RKLT.cc:90-116). Per update the grid tracker steps; the
    refiner is re-seated on the grid's corners and steps; where a
    tracker's refined corners leave the grid's by more than
    `failure_thresh_px` (the largest corner distance), it keeps the grid's
    corners and its refiner is re-seated there. With feedback the grid
    then follows the final corners.

The JAX package vmaps each composite per tracker, so its `lax.cond`s
decide per tracker; here each is a (B,) mask applied by `where_state`.
Each composite's `update_multi` (one frame per tracker, (B, H, W[, C]))
steps its members' `update_multi`, where `update` steps their `update`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from mtf_tpu_torch.sm.core import image_corners, multi_frames
from mtf_tpu_torch.utils.pyramid import build_pyramid


class CompositeState(NamedTuple):
    """Member states and composite bookkeeping (RKLT: (final corners
    (B, 4, 2),); ParallelSM: (fused corners (B, 4, 2),); CascadeSM and
    PyramidalSM: ())."""
    members: tuple
    extra: tuple = ()


def where_state(mask: torch.Tensor, a, b):
    """Per-tracker choice between two states of one structure: `a` where
    mask (B,) is set, else `b`, leaf by leaf. A leaf that is the same
    object in both (the grid's host step counter, its shared previous
    frame, anything the choice leaves alone) is kept as it is."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor):
        if a.dim() == 0 or a.shape[0] != mask.shape[0]:
            raise ValueError(f"where_state: leaf of shape {tuple(a.shape)} "
                             f"is not batched over {mask.shape[0]} trackers")
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    if isinstance(a, tuple):
        vals = [where_state(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    raise ValueError(f"where_state: cannot choose between "
                     f"{type(a).__name__} and {type(b).__name__}")


def member_corners(sm, state) -> torch.Tensor:
    """Image corners (B, 4, 2) of any tracker's state."""
    return sm.corners(state).transpose(-1, -2)


class _Composite(nn.Module):
    """Shared plumbing: `members` (an `nn.ModuleList`), the device, the
    frame conversion."""

    @property
    def device(self) -> torch.device:
        return self.members[-1].device

    def _frame(self, frame) -> torch.Tensor:
        return torch.as_tensor(frame, dtype=torch.float32,
                               device=self.device)

    def update(self, state: CompositeState, frame) -> CompositeState:
        return self._step(state, self._frame(frame), False)

    def update_multi(self, state: CompositeState, frames) -> CompositeState:
        """One update, each tracker on its own frame of frames (B, H, W)
        or (B, H, W, C)."""
        return self._step(state, multi_frames(frames, self.device), True)


def _member_update(m, st, frame, multi: bool):
    return m.update_multi(st, frame) if multi else m.update(st, frame)


class CascadeSM(_Composite):
    """Sequential composition (reference CascadeSM.cc; the shorthands
    `grfc`, `gres`): member k starts from member k-1's corners, and the
    last member's corners are the estimate. `auto_reinit_thresh` (px):
    a member whose result leaves its starting corners by more than this
    (largest corner distance) is reset to them, per tracker
    (CascadeTracker.cc:25-40)."""

    name = "casc"

    def __init__(self, members: list, auto_reinit_thresh=None):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.auto_reinit_thresh = auto_reinit_thresh
        self.ssm = members[-1].ssm

    def initialize(self, frame, corners) -> CompositeState:
        frame = self._frame(frame)
        return CompositeState(tuple(m.initialize(frame, corners)
                                    for m in self.members))

    def _step(self, state: CompositeState, frame,
              multi: bool) -> CompositeState:
        out, corners = [], None
        for m, st in zip(self.members, state.members):
            if corners is not None:
                st = m.set_region(st, corners)
            st = _member_update(m, st, frame, multi)
            c_new = member_corners(m, st)
            if self.auto_reinit_thresh is not None and corners is not None:
                div = torch.linalg.vector_norm(
                    c_new - corners, dim=-1).amax(-1) \
                    > self.auto_reinit_thresh
                st = where_state(div, m.set_region(st, corners), st)
                c_new = torch.where(div[:, None, None], corners, c_new)
            corners = c_new
            out.append(st)
        return CompositeState(tuple(out))

    def corners(self, state: CompositeState) -> torch.Tensor:
        """(B, 2, 4) corner matrices of the last member."""
        return self.members[-1].corners(state.members[-1])

    def set_region(self, state: CompositeState, corners,
                   frame=None) -> CompositeState:
        return CompositeState(tuple(
            m.set_region(st, corners)
            for m, st in zip(self.members, state.members)))


class ParallelSM(_Composite):
    """Concurrent members, fused by the mean of their corners (reference
    ParallelSM.cc); with `reset_to_mean` every member is reset to the
    fused region after each update. The fused corners are the state's
    `extra` from `initialize` on (the JAX package fills it at the first
    update), so the state keeps one structure."""

    name = "prl"

    def __init__(self, members: list, reset_to_mean: bool = True):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.reset_to_mean = reset_to_mean
        self.ssm = members[0].ssm

    def _fused(self, states) -> torch.Tensor:
        return torch.stack([member_corners(m, st) for m, st
                            in zip(self.members, states)]).mean(dim=0)

    def initialize(self, frame, corners) -> CompositeState:
        frame = self._frame(frame)
        states = tuple(m.initialize(frame, corners) for m in self.members)
        return CompositeState(states, extra=(self._fused(states),))

    def _step(self, state: CompositeState, frame,
              multi: bool) -> CompositeState:
        states = [_member_update(m, st, frame, multi)
                  for m, st in zip(self.members, state.members)]
        fused = self._fused(states)
        if self.reset_to_mean:
            states = [m.set_region(st, fused)
                      for m, st in zip(self.members, states)]
        return CompositeState(tuple(states), extra=(fused,))

    def corners(self, state: CompositeState) -> torch.Tensor:
        return state.extra[0].transpose(-1, -2)

    def set_region(self, state: CompositeState, corners,
                   frame=None) -> CompositeState:
        """Move every member to corners (B, 4, 2); `corners` then reports
        them (the JAX package keeps the previous fused corners)."""
        corners = torch.as_tensor(corners, dtype=torch.float32,
                                  device=self.device)
        return CompositeState(tuple(
            m.set_region(st, corners)
            for m, st in zip(self.members, state.members)), extra=(corners,))


class PyramidalSM(_Composite):
    """Coarse to fine over a Gaussian pyramid, one state of one SM per
    level (reference PyramidalSM.cc): the level-l tracker lives on the
    level-l image with corners / 2^l; per update the levels step from the
    coarsest, each re-seated on the coarser level's corners."""

    name = "pyr"

    def __init__(self, sm, n_levels: int = 3):
        super().__init__()
        self.members = nn.ModuleList([sm])
        self.sm = sm
        self.n_levels = n_levels
        self.ssm = sm.ssm

    def initialize(self, frame, corners) -> CompositeState:
        pyr = build_pyramid(self._frame(frame), self.n_levels)
        corners = torch.as_tensor(corners, dtype=torch.float32,
                                  device=self.device)
        return CompositeState(tuple(
            self.sm.initialize(pyr[lvl], corners / (2.0 ** lvl))
            for lvl in range(self.n_levels)))

    def _step(self, state: CompositeState, frame,
              multi: bool) -> CompositeState:
        pyr = build_pyramid(frame, self.n_levels)
        out, corners = list(state.members), None
        for lvl in reversed(range(self.n_levels)):
            st = out[lvl]
            if corners is not None:
                st = self.sm.set_region(st, corners / (2.0 ** lvl))
            st = _member_update(self.sm, st, pyr[lvl], multi)
            corners = member_corners(self.sm, st) * (2.0 ** lvl)
            out[lvl] = st
        return CompositeState(tuple(out))

    def corners(self, state: CompositeState) -> torch.Tensor:
        return self.sm.corners(state.members[0])

    def set_region(self, state: CompositeState, corners,
                   frame=None) -> CompositeState:
        return CompositeState(tuple(
            self.sm.set_region(st, corners / (2.0 ** lvl))
            for lvl, st in enumerate(state.members)))


@dataclass(frozen=True)
class RKLTParams:
    """Reference RKLTParams analog."""
    failure_thresh_px: float = 15.0  # refiner-vs-grid corner divergence
    enable_feedback: bool = True     # the grid follows the final estimate
    enable_spi: bool = False         # grid inlier mask -> refiner SPI


class RKLT(nn.Module):
    """Grid localizer + template refiner with failure fallback."""

    name = "rklt"

    def __init__(self, grid_sm, templ_sm, prm: RKLTParams | None = None):
        super().__init__()
        self.prm = prm or RKLTParams()
        self.grid_sm = grid_sm
        self.templ_sm = templ_sm
        self.ssm = templ_sm.ssm

    @property
    def device(self) -> torch.device:
        return self.templ_sm.device

    def initialize(self, frame, corners) -> CompositeState:
        grid_st = self.grid_sm.initialize(frame, corners)
        templ_st = self.templ_sm.initialize(frame, corners)
        return CompositeState(
            (grid_st, templ_st),
            extra=(image_corners(self.templ_sm.ssm, templ_st),))

    def update(self, state: CompositeState, frame) -> CompositeState:
        return self._step(state, torch.as_tensor(
            frame, dtype=torch.float32, device=self.device), False)

    def update_multi(self, state: CompositeState, frames) -> CompositeState:
        """One update, each tracker on its own frame of frames (B, H, W)
        or (B, H, W, C)."""
        return self._step(state, multi_frames(frames, self.device), True)

    def _step(self, state: CompositeState, frame,
              multi: bool) -> CompositeState:
        grid_st, templ_st = state.members
        grid_st = _member_update(self.grid_sm, grid_st, frame, multi)
        grid_corners = image_corners(self.grid_sm.ssm, grid_st)
        templ_st = self.templ_sm.set_region(templ_st, grid_corners)
        reseated = templ_st.ssm_state
        if self.prm.enable_spi:
            # grid inlier mask -> per-pixel SPI weights of the refiner: each
            # template pixel takes the flag of the grid cell it falls in
            # (NT/RKLT.cc:100); the refiner then runs its generic path
            templ_st = templ_st._replace(spi_mask=self._spi_mask(grid_st))
        templ_st = _member_update(self.templ_sm, templ_st, frame, multi)
        if self.prm.enable_spi:
            templ_st = templ_st._replace(spi_mask=None)
        templ_corners = image_corners(self.templ_sm.ssm, templ_st)
        # failure detection (NT/RKLT.cc:105-111), per tracker
        diverged = torch.linalg.vector_norm(
            templ_corners - grid_corners, dim=-1).amax(-1) \
            > self.prm.failure_thresh_px
        final = torch.where(diverged[:, None, None], grid_corners,
                            templ_corners)
        # re-seating on the grid's corners again gives the state that
        # set_region gave before the refiner's update
        templ_st = templ_st._replace(ssm_state=torch.where(
            diverged[:, None], reseated, templ_st.ssm_state))
        if self.prm.enable_feedback:  # NT/RKLT.cc:113-114
            grid_st = self.grid_sm.set_region(grid_st, final)
        return CompositeState((grid_st, templ_st), extra=(final,))

    def _spi_mask(self, grid_st) -> torch.Tensor:
        """(B, resy·resx) inlier flags of the grid cell of each template
        pixel."""
        inl = grid_st.extra.inlier_mask                     # (B, R·R)
        r = self.grid_sm.grid.grid_res
        resy, resx = self.templ_sm.am.prm.resy, self.templ_sm.am.prm.resx
        dev = inl.device
        ri = torch.arange(resy, device=dev) * r // resy
        ci = torch.arange(resx, device=dev) * r // resx
        pix = inl.reshape(-1, r, r)[:, ri[:, None], ci[None, :]]
        return pix.flatten(1)

    def corners(self, state: CompositeState) -> torch.Tensor:
        """(B, 2, 4) corner matrices of the final estimate."""
        return state.extra[0].transpose(-1, -2)

    def set_region(self, state: CompositeState, corners,
                   frame=None) -> CompositeState:
        """Move both members to corners (B, 4, 2); unlike the JAX
        package, which keeps the previous final corners, `corners` then
        reports the new ones."""
        grid_st, templ_st = state.members
        return CompositeState(
            (self.grid_sm.set_region(grid_st, corners),
             self.templ_sm.set_region(templ_st, corners)),
            extra=(corners,))
