"""Carry tracker state between the JAX package and the port.

`to_torch` takes the JAX package's FCLK, ESM, grid or RKLT tracker state
(SSD or NCC) as a pytree of numpy arrays (for example
`jax.tree.map(np.asarray, state)` or a loaded checkpoint) for one tracker
or a vmapped batch, and returns the port's batched state on a device
(None: the card). `to_numpy` goes back: it returns the port's
NamedTuples holding numpy arrays laid out as the JAX package lays them
out, so the JAX NamedTuples can be rebuilt field by field. Fields are
read by name; nothing of JAX is imported.

Layouts (JAX per tracker -> port, B leading):
  ssm_state (S,) -> (B, S); am_state.template (N, 1) -> (B, N, 1);
  am_state.p_am (0,) -> (B, 0); am_state.extra () for SSD, (n0 (N, 1),)
  for NCC -> batched; region.norm_mat (3, 3), base_pts (N, 2),
  base_corners (4, 2) -> batched;
  LK extra: J0 (N, S), H0 (S, S) and each coarse pack (templ_s (n_s,),
  H0_s (S, S), J_s (n_s, S)) -> batched;
  grid extra: templates (L, P, n, 1), offsets (n, 2), centers0 (P, 2),
  inlier_mask (P,) -> batched. The JAX `key` has no counterpart: the
  port's update counter `step` (a 0-d int64 CPU tensor) starts at 0, and
  `to_numpy` returns it as `step`, so a caller rebuilding the JAX state
  supplies a key. `prev_frame` must be None (the port has no
  forward-backward or frame-to-frame flow);
  RKLT (`CompositeState`): members (grid state, refiner state), extra
  (final corners (4, 2),) -> batched. A JAX state straight from
  `initialize` has no final corners yet; the port takes the refiner's.
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch import _device
from mtf_tpu_torch.am.base import AMState
from mtf_tpu_torch.sm.composite import CompositeState
from mtf_tpu_torch.sm.core import RegionState, TrackerState, image_corners
from mtf_tpu_torch.sm.grid import GridState
from mtf_tpu_torch.sm.lk import LKCache
from mtf_tpu_torch.ssm.projective import Homography


def _is_composite(jstate) -> bool:
    return hasattr(jstate, "members")


def _ssm_state(jstate):
    return (jstate.members[0] if _is_composite(jstate) else jstate).ssm_state


def to_torch(jstate, device=None):
    """JAX-layout numpy state (single or batched) -> port state."""
    single = np.ndim(_ssm_state(jstate)) == 1
    device = _device.resolve(device)

    def t(x):
        a = np.asarray(x, np.float32)
        return torch.as_tensor(a[None] if single else a, device=device)

    def extra_of(ex):
        if hasattr(ex, "templates"):
            if ex.prev_frame is not None:
                raise NotImplementedError(
                    "grid states with a previous frame (forward-backward "
                    "or frame-to-frame flow) come with ROADMAP Queue 1c")
            return GridState(templates=t(ex.templates), offsets=t(ex.offsets),
                             centers0=t(ex.centers0),
                             step=torch.zeros((), dtype=torch.int64),
                             inlier_mask=t(ex.inlier_mask))
        return LKCache(J0=t(ex.J0), H0=t(ex.H0),
                       coarse=tuple(tuple(t(x) for x in pack)
                                    for pack in ex.coarse))

    def tracker(js):
        am, rg = js.am_state, js.region
        return TrackerState(
            ssm_state=t(js.ssm_state),
            am_state=AMState(template=t(am.template), p_am=t(am.p_am),
                             extra=tuple(t(x) for x in am.extra)),
            region=RegionState(norm_mat=t(rg.norm_mat),
                               base_pts=t(rg.base_pts),
                               base_corners=t(rg.base_corners)),
            extra=extra_of(js.extra))

    if not _is_composite(jstate):
        return tracker(jstate)
    members = tuple(tracker(m) for m in jstate.members)
    if jstate.extra:
        final = t(jstate.extra[0])
    else:
        final = image_corners(Homography(device=device), members[-1])
    return CompositeState(members, extra=(final,))


def to_numpy(state, squeeze: bool = False):
    """Port state -> numpy arrays in the JAX layout; `squeeze` drops the
    batch axis of a one-tracker state."""
    def n(x):
        a = x.detach().cpu().numpy()
        return a[0] if squeeze else a

    def extra_of(ex):
        if isinstance(ex, GridState):
            return GridState(templates=n(ex.templates), offsets=n(ex.offsets),
                             centers0=n(ex.centers0), step=ex.step.numpy(),
                             inlier_mask=n(ex.inlier_mask))
        return LKCache(J0=n(ex.J0), H0=n(ex.H0),
                       coarse=tuple(tuple(n(x) for x in pack)
                                    for pack in ex.coarse))

    def tracker(st):
        am, rg = st.am_state, st.region
        return TrackerState(
            ssm_state=n(st.ssm_state),
            am_state=AMState(template=n(am.template), p_am=n(am.p_am),
                             extra=tuple(n(x) for x in am.extra)),
            region=RegionState(norm_mat=n(rg.norm_mat),
                               base_pts=n(rg.base_pts),
                               base_corners=n(rg.base_corners)),
            extra=extra_of(st.extra))

    if isinstance(state, CompositeState):
        return CompositeState(tuple(tracker(m) for m in state.members),
                              extra=tuple(n(x) for x in state.extra))
    return tracker(state)
