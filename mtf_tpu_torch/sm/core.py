"""Tracker core (port of `mtf_tpu/sm/core.py`): state, region
normalization and the search-method protocol, over a batch of B trackers.

    initialize: (frame, corners (B, 4, 2)) -> TrackerState
    update:     (TrackerState, frame)      -> TrackerState
    corners:    TrackerState               -> (B, 2, 4) corner matrices

The SSM state lives in a template frame: each init region mapped to a
centered, unit-scale square by a similarity `norm_mat`, which keeps the
8-DOF Gauss-Newton solves well-conditioned in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch import nn

from mtf_tpu_torch.am.base import AM, AMState
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.linalg import inv3x3
from mtf_tpu_torch.ssm.base import SSM


class RegionState(NamedTuple):
    """Geometry of the tracked regions."""
    norm_mat: torch.Tensor      # (B, 3, 3) template frame -> image
    base_pts: torch.Tensor      # (B, N, 2) sampling grid, template frame
    base_corners: torch.Tensor  # (B, 4, 2) corners, template frame


class TrackerState(NamedTuple):
    """Batched tracker state."""
    ssm_state: torch.Tensor     # (B, S) warp params in the template frame
    am_state: AMState
    region: RegionState
    extra: Any = ()             # SM-specific cache (LKCache for LK)


@dataclass(frozen=True)
class SMParams:
    """Search-method configuration (the fields the ported slice reads)."""
    max_iters: int = 30
    epsilon: float = 0.01          # corner-change convergence threshold (px)
    interp: str = "linear"
    border: str = "replicate"
    crop: int | None = None        # window size for dense sampling
    coarse_pt_iters: tuple = ()    # ((stride, n_iters), ...) coarse phases
    hess_type: str = "self0"
    jac_type: str = "original"     # original | diff_of_jacs (ESM)
    enable_lm: bool = False        # Levenberg-Marquardt damping w/ rollback
    lm_delta0: float = 1e-3
    lm_up: float = 10.0
    lm_down: float = 0.1


def make_region(corners_img: torch.Tensor, resx: int,
                resy: int) -> RegionState:
    """Normalized template frames from init corners (B, 4, 2)."""
    c = corners_img.mean(dim=-2)                             # (B, 2)
    scale = torch.linalg.vector_norm(corners_img - c[..., None, :],
                                     dim=-1).mean(dim=-1)
    scale = torch.clamp(scale, min=1e-6)
    T = torch.zeros(corners_img.shape[:-2] + (3, 3),
                    dtype=corners_img.dtype, device=corners_img.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = c[..., 0]
    T[..., 1, 2] = c[..., 1]
    T[..., 2, 2] = 1.0
    Tinv = inv3x3(T)
    grid_img = W.grid_from_corners(corners_img, resx, resy)
    return RegionState(norm_mat=T,
                       base_pts=W.apply_warp(Tinv, grid_img),
                       base_corners=W.apply_warp(Tinv, corners_img))


def image_corners(ssm: SSM, state: TrackerState) -> torch.Tensor:
    """Current region corners (B, 4, 2) in image coordinates."""
    c_t = ssm.warp_pts(state.ssm_state, state.region.base_corners)
    return W.apply_warp(state.region.norm_mat, c_t)


class SearchMethod(nn.Module):
    """Base SM binding one AM and one SSM. Subclasses implement
    `_init_extra` and `_update`."""

    name = "base"

    def __init__(self, am: AM, ssm: SSM, prm: SMParams | None = None):
        super().__init__()
        self.am = am
        self.ssm = ssm
        self.prm = prm or SMParams()

    @property
    def device(self) -> torch.device:
        return self.ssm.generators.device

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        return ()

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        raise NotImplementedError

    def initialize(self, frame: torch.Tensor,
                   corners_img: torch.Tensor) -> TrackerState:
        """Initialize B trackers on one frame from corners (B, 4, 2)."""
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        corners_img = torch.as_tensor(corners_img, dtype=torch.float32,
                                      device=self.device)
        region = make_region(corners_img, self.am.prm.resx, self.am.prm.resy)
        pts0 = W.apply_warp(region.norm_mat, region.base_pts)
        patch0 = interp.sample(frame, pts0, self.prm.interp, self.prm.border)
        st = TrackerState(ssm_state=self.ssm.identity(corners_img.shape[:-2]),
                          am_state=self.am.init(patch0), region=region)
        return st._replace(extra=self._init_extra(st, frame))

    def update(self, state: TrackerState,
               frame: torch.Tensor) -> TrackerState:
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        return self._update(state, frame)

    def corners(self, state: TrackerState) -> torch.Tensor:
        """(B, 2, 4) MTF corner matrices."""
        return image_corners(self.ssm, state).transpose(-1, -2)

    def set_region(self, state: TrackerState,
                   corners_img: torch.Tensor) -> TrackerState:
        """Move each tracked region to corners (B, 4, 2) without touching
        its template: the corners are mapped back into the template frame
        and the SSM state is fitted to them."""
        c_t = W.apply_warp(inv3x3(state.region.norm_mat), corners_img)
        return state._replace(
            ssm_state=self.ssm.fit_pts(state.region.base_corners, c_t))
