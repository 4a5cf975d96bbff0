"""Tracker core (port of `mtf_tpu/sm/core.py`): state, region
normalization and the search-method protocol, over a batch of B trackers.

    initialize:   (frame, corners (B, 4, 2))  -> TrackerState
    update:       (TrackerState, frame)       -> TrackerState
    update_multi: (TrackerState, frames (B, H, W[, C])), one frame per
                  tracker                     -> TrackerState
    corners:      TrackerState                -> (B, 2, 4) corner matrices

The SSM state lives in a template frame: each init region mapped to a
centered, unit-scale square by a similarity `norm_mat`, which keeps the
8-DOF Gauss-Newton solves well-conditioned in float32.

Per-tracker frames by index: a `FrameStack` (frames (F, H, W, C), index
(B,)) has tracker t read frame index[t], which the samplers
(`ops/interp.py`), the LK windows and the chain kernel take without
copying a frame per tracker (the sub-tracker grid's B·P sub-trackers on
their B parents' frames); `tracker_frames` gives the other search
methods their (B, H, W, C) stack.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
from torch import nn

from mtf_tpu_torch.am.base import AM, AMState
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.interp import FrameStack
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
    spi_mask: Any = None        # optional external (B, N) pixel weights
                                # (RKLT feeds the grid's inlier mask here)


@dataclass(frozen=True)
class SMParams:
    """Search-method configuration (reference per-SM param structs)."""
    max_iters: int = 30
    epsilon: float = 0.01          # corner-change convergence threshold (px)
    interp: str = "linear"         # + "<kind>_mm": dense sampling
    border: str = "replicate"
    crop: int | None = None        # window size for dense sampling
    crop_blocks: tuple | None = None  # (by, bx): tiled dense sampling, each
                                   # tile in its own `crop` (default 64)
                                   # window (the generic path)
    use_pallas: bool | None = None  # None or True: the chain kernel where
                                   # the configuration fits it (`LKBase.
                                   # _fused_ok`); False: the generic path
    interp_bf16: bool = False      # bfloat16 image values and tap weights,
                                   # float32 sums, in the dense samplers
    interp_precision: str | None = None  # "highest": the JAX package's
                                   # full-float32 sampling contractions
                                   # (what the port computes anyway)
    coarse_pt_iters: tuple = ()    # ((stride, n_iters), ...) coarse phases
    hess_type: str = "self0"       # self0 | selft | std | std2
    jac_type: str = "original"     # original | diff_of_jacs (ESM)
    enable_lm: bool = False        # Levenberg-Marquardt damping w/ rollback
    spi_type: str | None = None    # SPI mask: pix_diff | gradient | gftt
    spi_thresh: float = 0.2
    lm_delta0: float = 1e-3
    lm_up: float = 10.0
    lm_down: float = 0.1
    sd_learning_rate: float = 0.1  # FCSD step size
    extra: dict = field(default_factory=dict)  # options of a caller's own


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


def corners_at(ssm: SSM, region: RegionState,
               s: torch.Tensor) -> torch.Tensor:
    """Region corners (B, 4, 2) in image coordinates at states s (B, S)."""
    return W.apply_warp(region.norm_mat, ssm.warp_pts(s, region.base_corners))


def points_at(ssm: SSM, region: RegionState, s: torch.Tensor) -> torch.Tensor:
    """Image points (B, ..., N, 2) of the sampling grid at states s
    (B, ..., S), any number of states per tracker."""
    extra = s.dim() - 2
    bp = region.base_pts.view(region.base_pts.shape[:1] + (1,) * extra
                              + region.base_pts.shape[1:])
    nm = region.norm_mat.view(region.norm_mat.shape[:1] + (1,) * extra
                              + (3, 3))
    return W.apply_warp(nm, ssm.warp_pts(s, bp))


def image_pts(ssm: SSM, state: TrackerState) -> torch.Tensor:
    """Current sampling grids (B, N, 2) in image coordinates."""
    return points_at(ssm, state.region, state.ssm_state)


def image_corners(ssm: SSM, state: TrackerState) -> torch.Tensor:
    """Current region corners (B, 4, 2) in image coordinates."""
    return corners_at(ssm, state.region, state.ssm_state)


def sample_patch(frame: torch.Tensor, pts: torch.Tensor,
                 prm: SMParams) -> torch.Tensor:
    """Patches (B, N, C) of `frame` at points (B, N, 2) with the search
    method's taps and border."""
    return interp.sample(frame, pts, prm.interp, prm.border)


def sampler_sigma(ssm: SSM, region: RegionState, ssm_sigma: tuple,
                  pix_sigma: float) -> torch.Tensor:
    """(B, S) perturbation sigmas of the stochastic and learned SMs:
    `ssm_sigma` for every tracker where given, else the state sigmas that
    move the points by `pix_sigma` image pixels (the base points live in
    the normalised template frame)."""
    B = region.norm_mat.shape[0]
    if ssm_sigma:
        return torch.as_tensor(ssm_sigma, dtype=torch.float32,
                               device=region.norm_mat.device).expand(B, -1)
    return ssm.state_sigma_from_pixel_sigma(
        pix_sigma / region.norm_mat[:, 0, 0], region.base_pts)


def _mix32(x: int) -> int:
    """splitmix64's finaliser of a 64-bit int, cut to its low 32 bits (0
    stays 0)."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0xFFFFFFFF


def seeded_generator(seed: int, step: int, salt: int,
                     device) -> torch.Generator:
    """The generator of one update's draws: a function of (seed, step) and
    the search method's `salt` alone."""
    gen = torch.Generator(device=device)
    v = ((seed & 0x7FFFFFFF) << 32) + (salt << 28) + (step & 0xFFFFFFF)
    if gen.device.type == "cpu":
        # the CPU generator (mt19937) keeps the seed's low 32 bits only:
        # fold a hash of the high ones into them (unchanged for seed 0)
        v = (v & 0xFFFFFFFF) ^ _mix32(v >> 32)
    gen.manual_seed(v)
    return gen


def converge(ssm: SSM, region: RegionState, s: torch.Tensor, n_iters: int,
             epsilon: float, dp_of) -> torch.Tensor:
    """Up to `n_iters` compositional steps s <- s . dp_of(s) (B, S); a
    tracker whose corners moved less than `epsilon` px freezes for the
    rest (the JAX package's vmapped `while_loop`: the step that stops it
    is kept)."""
    done = torch.zeros((s.shape[0],), dtype=torch.bool, device=s.device)
    for _ in range(n_iters):
        s_new = ssm.compositional_update(s, dp_of(s))
        change = torch.linalg.vector_norm(
            corners_at(ssm, region, s_new) - corners_at(ssm, region, s),
            dim=-1).amax(-1)
        s = torch.where(done[:, None], s, s_new)
        done = done | (change < epsilon)
    return s


def is_gray(frame) -> bool:
    """An (H, W) frame, or per-tracker frames (B, H, W, 1)."""
    return frame.dim() == 2 or (frame.dim() == 4 and frame.shape[-1] == 1)


def tracker_frames(frames) -> torch.Tensor:
    """Per-tracker frames (B, H, W, C): the stack itself, or a
    `FrameStack`'s frames gathered by its index (one copy per tracker)."""
    if isinstance(frames, FrameStack):
        return frames.frames[frames.index]
    return frames


def multi_frames(frames, device) -> torch.Tensor:
    """Per-tracker frames (B, H, W) or (B, H, W, C) as the (B, H, W, C)
    float32 stack the search methods' `update_multi` reads."""
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    if frames.dim() == 3:
        frames = frames[..., None]
    if frames.dim() != 4:
        raise ValueError(f"per-tracker frames are (B, H, W) or (B, H, W, C), "
                         f"got {tuple(frames.shape)}")
    return frames


def track_sequence(sm, frames, corners0, state0=None):
    """Track B regions over a frame stack (T, H, W[, C]) shared by the
    trackers, one batched update per frame (`mtf_tpu/sm/core.py:134`):
    from `sm.initialize(frames[0], corners0)` over frames[1:], or from
    `state0` over every frame. Returns (the final state, the corners
    (T', B, 2, 4) after each update)."""
    if state0 is None:
        state0 = sm.initialize(frames[0], corners0)
        frames = frames[1:]
    state, out = state0, []
    for frame in frames:
        state = sm.update(state, frame)
        out.append(sm.corners(state))
    return state, torch.stack(out)


def multi_unported(sm):
    """The error of a host-detection tracker's `update_multi`: per-tracker
    frames take a device-only tracker, as in the JAX package (whose fleet
    `vmap`s `update`, which these trackers' host detection cannot be)."""
    return NotImplementedError(
        f"{type(sm).__name__}.update_multi: per-tracker frames need a "
        "device-only tracker; this one detects on the host (not jittable "
        "in the JAX package either)")


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
        return self.ssm.device

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
        patch0 = sample_patch(frame, pts0, self.prm)
        st = TrackerState(ssm_state=self.ssm.identity(corners_img.shape[:-2]),
                          am_state=self.am.init(patch0), region=region)
        return st._replace(extra=self._init_extra(st, frame))

    def update(self, state: TrackerState,
               frame: torch.Tensor) -> TrackerState:
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        return self._update(state, frame)

    def update_multi(self, state: TrackerState, frames) -> TrackerState:
        """One update of the B trackers, each on its own frame: frames
        (B, H, W) or (B, H, W, C), batched as `update` is."""
        frames = multi_frames(frames, self.device)
        if frames.shape[0] != state.ssm_state.shape[0]:
            raise ValueError(f"{frames.shape[0]} frames for "
                             f"{state.ssm_state.shape[0]} trackers")
        return self._update_multi(state, frames)

    def _update_multi(self, state: TrackerState, frames) -> TrackerState:
        """The update on per-tracker frames (B, H, W, C) or a
        `FrameStack`; search methods whose frame reads are all samples of
        per-tracker images take it through `_update`."""
        return self._update(state, tracker_frames(frames))

    def corners(self, state: TrackerState) -> torch.Tensor:
        """(B, 2, 4) MTF corner matrices."""
        return image_corners(self.ssm, state).transpose(-1, -2)

    def set_region(self, state: TrackerState, corners_img: torch.Tensor,
                   frame=None) -> TrackerState:
        """Move each tracked region to corners (B, 4, 2) without touching
        its template: the corners are mapped back into the template frame
        and the SSM state is fitted to them (`frame`, the JAX signature's,
        is not read)."""
        c_t = W.apply_warp(inv3x3(state.region.norm_mat), corners_img)
        return state._replace(
            ssm_state=self.ssm.fit_pts(state.region.base_corners, c_t))

    def reinitialize(self, frame: torch.Tensor,
                     corners_img: torch.Tensor) -> TrackerState:
        """A fresh template at new corners (B, 4, 2): the reinit-on-failure
        protocol's `initialize` (runMTF.cc:499-547)."""
        return self.initialize(frame, corners_img)
