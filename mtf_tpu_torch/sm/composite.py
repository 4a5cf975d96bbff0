"""Composite search methods (port of `mtf_tpu/sm/composite.py`): RKLT,
the grid localizer with a template refiner and failure fallback
(reference NT/RKLT.cc:90-116), over a leading batch of B trackers.

Per update: the grid tracker steps; the refiner is re-seated on the
grid's corners and steps; where a tracker's refined corners leave the
grid's by more than `failure_thresh_px` (the largest corner distance),
it keeps the grid's corners and its refiner is re-seated there. With
feedback the grid then follows the final corners. The JAX package's
`lax.cond` on divergence is a per-tracker (B,) `torch.where`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from mtf_tpu_torch.sm.core import image_corners


class CompositeState(NamedTuple):
    """Member states and composite bookkeeping (RKLT: (final corners
    (B, 4, 2),))."""
    members: tuple
    extra: tuple = ()


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
        if self.prm.enable_spi:
            raise NotImplementedError(
                "RKLT's enable_spi is not ported yet: it needs the LK "
                "refiner's SPI mask, which comes with ROADMAP Queue 1b")
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
        frame = torch.as_tensor(frame, dtype=torch.float32,
                                device=self.device)
        grid_st, templ_st = state.members
        grid_st = self.grid_sm.update(grid_st, frame)
        grid_corners = image_corners(self.grid_sm.ssm, grid_st)
        templ_st = self.templ_sm.set_region(templ_st, grid_corners)
        reseated = templ_st.ssm_state
        templ_st = self.templ_sm.update(templ_st, frame)
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

    def corners(self, state: CompositeState) -> torch.Tensor:
        """(B, 2, 4) corner matrices of the final estimate."""
        return state.extra[0].transpose(-1, -2)

    def set_region(self, state: CompositeState, corners) -> CompositeState:
        """Move both members to corners (B, 4, 2); unlike the JAX
        package, which keeps the previous final corners, `corners` then
        reports the new ones."""
        grid_st, templ_st = state.members
        return CompositeState(
            (self.grid_sm.set_region(grid_st, corners),
             self.templ_sm.set_region(templ_st, corners)),
            extra=(corners,))
