"""Carry tracker state between the JAX package and the port.

`to_torch` takes the JAX package's FCLK, ESM, grid (any flow, Median
Flow included), sub-tracker grid, RKLT, cascade, parallel or pyramidal
tracker state (SSD or NCC, any matrix SSM; composites nested in
composites too) as a pytree of numpy arrays
(for example `jax.tree.map(np.asarray, state)` or a loaded checkpoint)
for one tracker or a vmapped batch, and returns the port's batched state
on a device (None: the card). `to_numpy` goes back: it returns the port's
NamedTuples holding numpy arrays laid out as the JAX package lays them
out, so the JAX NamedTuples can be rebuilt field by field. Fields are
read by name; nothing of JAX is imported.

Layouts (JAX per tracker -> port, B leading; C channels, 1 for gray,
3 for mcssd; the tap kind of `interp` changes none of them):
  ssm_state (S,) -> (B, S); am_state.template (N, C) -> (B, N, C);
  am_state.p_am (0,) -> (B, 0); am_state.extra () for SSD, (n0 (N, 1),)
  for NCC -> batched; region.norm_mat (3, 3), base_pts (N, 2),
  base_corners (4, 2) -> batched;
  LK extra: J0 (N·C, S) with rows interleaved n·C + c, H0 (S, S) and
  each coarse pack (templ_s (n_s,) for gray or (n_s, C), H0_s (S, S),
  J_s (n_s·C, S), interleaved alike) -> batched, the port keeping the JAX
  package's row order;
  grid extra: templates (L, P, n, C), offsets (n, 2), centers0 (P, 2),
  inlier_mask (P,) -> batched. The JAX `key` has no counterpart: the
  port's update counter `step` (a 0-d int64 CPU tensor) starts at 0, and
  `to_numpy` returns it as `step`, so a caller rebuilding the JAX state
  supplies a key. Sub-tracker grid extra (`SubGridState`): sub_states,
  the P sub-trackers' states with a leading P (B, P batched) -> one flat
  batch of B·P (tracker-major), centers0 (P, 2), half_img (),
  inlier_mask (P,) -> batched; its `key` becomes `step` as the grid's
  does. `prev_frame` (H, W[, C]), held by f2f and
  forward-backward grids: a vmapped JAX state holds B copies of the one
  shared frame; `to_torch` checks that they are equal and keeps one,
  `to_numpy` gives the B copies back as a broadcast view;
  composites (`CompositeState`): members in order (RKLT: grid, refiner;
  a cascade or parallel composite: its members; a pyramidal one: its
  levels, finest first), extra RKLT (final corners (4, 2),), ParallelSM
  (fused corners (4, 2),), CascadeSM and PyramidalSM () -> batched. A
  JAX RKLT or parallel state straight from `initialize` has no corners
  in `extra` yet: the port fills them (RKLT: the refiner's; parallel:
  the mean of the members'), each through its member's SSM. Which
  composite a state belongs to is read from `sm`, the port's tracker;
  without it a composite is taken for RKLT, and its corners are filled
  only for an 8-DOF refiner, taken for the homography.
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch import _device
from mtf_tpu_torch.am.base import AMState
from mtf_tpu_torch.sm.composite import (RKLT, CascadeSM, CompositeState,
                                        ParallelSM, PyramidalSM)
from mtf_tpu_torch.sm.core import RegionState, TrackerState, image_corners
from mtf_tpu_torch.sm.grid import GridState, SubGridState
from mtf_tpu_torch.sm.lk import LKCache
from mtf_tpu_torch.ssm.projective import Homography


def _is_composite(jstate) -> bool:
    return hasattr(jstate, "members")


def _ssm_state(jstate):
    while _is_composite(jstate):
        jstate = jstate.members[0]
    return jstate.ssm_state


def _member_sms(sm, k: int) -> list:
    """The port's trackers of a composite's k member states (None where
    `sm` is not given)."""
    if isinstance(sm, RKLT):
        return [sm.grid_sm, sm.templ_sm]
    if isinstance(sm, PyramidalSM):
        return [sm.sm] * k
    if isinstance(sm, (CascadeSM, ParallelSM)):
        return list(sm.members)
    return [None] * k


def _one_frame(prev, single: bool):
    """The shared previous frame of a JAX grid state (B copies when
    batched)."""
    a = np.asarray(prev, np.float32)
    if single:
        return a
    if not all(np.array_equal(a[0], x) for x in a[1:]):
        raise ValueError("grid state: the trackers' previous frames differ; "
                         "the port keeps one frame shared by the fleet")
    return a[0]


def to_torch(jstate, device=None, sm=None):
    """JAX-layout numpy state (single or batched) -> port state; `sm`,
    the port's tracker, tells composites apart (see the module doc)."""
    single = np.ndim(_ssm_state(jstate)) == 1
    device = _device.resolve(device)

    def t(x):
        # a copy: a donating fleet writes into the state's tensors
        a = np.asarray(x, np.float32)
        return torch.tensor(a[None] if single else a, device=device)

    def flat(x):
        # a sub-tracker leaf (P, ...) or (B, P, ...) -> (B·P, ...)
        a = np.asarray(x, np.float32)
        if not single:
            a = a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
        return torch.tensor(a, device=device)

    def extra_of(ex, f=t):
        if hasattr(ex, "sub_states"):
            return SubGridState(
                sub_states=tracker(ex.sub_states, flat),
                centers0=t(ex.centers0), half_img=t(ex.half_img),
                step=torch.zeros((), dtype=torch.int64),
                inlier_mask=t(ex.inlier_mask))
        if hasattr(ex, "templates"):
            prev = None
            if ex.prev_frame is not None:
                prev = torch.tensor(_one_frame(ex.prev_frame, single),
                                    device=device)
            return GridState(templates=t(ex.templates), offsets=t(ex.offsets),
                             centers0=t(ex.centers0),
                             step=torch.zeros((), dtype=torch.int64),
                             inlier_mask=t(ex.inlier_mask), prev_frame=prev)
        return LKCache(J0=f(ex.J0), H0=f(ex.H0),
                       coarse=tuple(tuple(f(x) for x in pack)
                                    for pack in ex.coarse))

    def tracker(js, f=t):
        am, rg = js.am_state, js.region
        return TrackerState(
            ssm_state=f(js.ssm_state),
            am_state=AMState(template=f(am.template), p_am=f(am.p_am),
                             extra=tuple(f(x) for x in am.extra)),
            region=RegionState(norm_mat=f(rg.norm_mat),
                               base_pts=f(rg.base_pts),
                               base_corners=f(rg.base_corners)),
            extra=extra_of(js.extra, f))

    def convert(js, m):
        if not _is_composite(js):
            return tracker(js)
        members = tuple(convert(x, s) for x, s
                        in zip(js.members, _member_sms(m, len(js.members))))
        if js.extra:
            return CompositeState(members, extra=tuple(t(x)
                                                       for x in js.extra))
        if isinstance(m, (CascadeSM, PyramidalSM)):
            return CompositeState(members)
        if isinstance(m, ParallelSM):
            return CompositeState(members, extra=(m._fused(members),))
        if isinstance(m, RKLT):
            ssm = m.templ_sm.ssm
        elif members[-1].ssm_state.shape[-1] == 8:
            ssm = Homography(device=device)
        else:
            raise ValueError("to_torch: an RKLT state without corners needs "
                             "sm=, the port's tracker, for its refiner's SSM")
        return CompositeState(members, extra=(image_corners(
            ssm, members[-1]),))

    return convert(jstate, sm)


def to_numpy(state, squeeze: bool = False):
    """Port state -> numpy arrays in the JAX layout; `squeeze` drops the
    batch axis of a one-tracker state."""
    def n(x):
        a = x.detach().cpu().numpy()
        return a[0] if squeeze else a

    def extra_of(ex, f=n):
        if isinstance(ex, SubGridState):
            b = ex.centers0.shape[0]

            def unflat(x):
                a = x.detach().cpu().numpy()
                a = a.reshape((b, a.shape[0] // b) + a.shape[1:])
                return a[0] if squeeze else a
            return SubGridState(sub_states=tracker(ex.sub_states, unflat),
                                centers0=n(ex.centers0),
                                half_img=n(ex.half_img), step=ex.step.numpy(),
                                inlier_mask=n(ex.inlier_mask))
        if isinstance(ex, GridState):
            prev = None
            if ex.prev_frame is not None:
                prev = ex.prev_frame.detach().cpu().numpy()
                if not squeeze:
                    prev = np.broadcast_to(prev, (ex.templates.shape[0],)
                                           + prev.shape)
            return GridState(templates=n(ex.templates), offsets=n(ex.offsets),
                             centers0=n(ex.centers0), step=ex.step.numpy(),
                             inlier_mask=n(ex.inlier_mask), prev_frame=prev)
        return LKCache(J0=f(ex.J0), H0=f(ex.H0),
                       coarse=tuple(tuple(f(x) for x in pack)
                                    for pack in ex.coarse))

    def tracker(st, f=n):
        if isinstance(st, CompositeState):
            return CompositeState(tuple(tracker(m) for m in st.members),
                                  extra=tuple(n(x) for x in st.extra))
        am, rg = st.am_state, st.region
        return TrackerState(
            ssm_state=f(st.ssm_state),
            am_state=AMState(template=f(am.template), p_am=f(am.p_am),
                             extra=tuple(f(x) for x in am.extra)),
            region=RegionState(norm_mat=f(rg.norm_mat),
                               base_pts=f(rg.base_pts),
                               base_corners=f(rg.base_corners)),
            extra=extra_of(st.extra, f))

    return tracker(state)
