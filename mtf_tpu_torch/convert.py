"""Carry tracker state between the JAX package and the port.

`to_torch` takes the JAX package's FCLK or ESM tracker state (SSD or
NCC) as a pytree of numpy arrays (for example
`jax.tree.map(np.asarray, state)` or a loaded checkpoint) for one tracker
or a vmapped batch, and returns the port's batched `TrackerState` on a
device (None: the card). `to_numpy` goes back: it returns the port's
NamedTuples holding numpy arrays laid out as the JAX package lays
them out, so `mtf_tpu.sm.core.TrackerState(*...)` can rebuild the JAX
state field by field. Fields are read by name; nothing of JAX is
imported.

Layouts (JAX per tracker -> port, B leading):
  ssm_state (S,) -> (B, S); am_state.template (N, 1) -> (B, N, 1);
  am_state.p_am (0,) -> (B, 0); am_state.extra () for SSD, (n0 (N, 1),)
  for NCC -> batched; region.norm_mat (3, 3), base_pts (N, 2),
  base_corners (4, 2) -> batched; extra J0 (N, S), H0 (S, S) and each
  coarse pack (templ_s (n_s,), H0_s (S, S), J_s (n_s, S)) -> batched.
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch import _device
from mtf_tpu_torch.am.base import AMState
from mtf_tpu_torch.sm.core import RegionState, TrackerState
from mtf_tpu_torch.sm.lk import LKCache


def to_torch(jstate, device=None) -> TrackerState:
    """JAX-layout numpy state (single or batched) -> port state."""
    single = np.ndim(jstate.ssm_state) == 1
    device = _device.resolve(device)

    def t(x):
        a = np.asarray(x, np.float32)
        return torch.as_tensor(a[None] if single else a, device=device)

    am = jstate.am_state
    rg = jstate.region
    ex = jstate.extra
    return TrackerState(
        ssm_state=t(jstate.ssm_state),
        am_state=AMState(template=t(am.template), p_am=t(am.p_am),
                         extra=tuple(t(x) for x in am.extra)),
        region=RegionState(norm_mat=t(rg.norm_mat), base_pts=t(rg.base_pts),
                           base_corners=t(rg.base_corners)),
        extra=LKCache(J0=t(ex.J0), H0=t(ex.H0),
                      coarse=tuple(tuple(t(x) for x in pack)
                                   for pack in ex.coarse)))


def to_numpy(state: TrackerState, squeeze: bool = False) -> TrackerState:
    """Port state -> numpy arrays in the JAX layout; `squeeze` drops the
    batch axis of a one-tracker state."""
    def n(x):
        a = x.detach().cpu().numpy()
        return a[0] if squeeze else a

    am, rg, ex = state.am_state, state.region, state.extra
    return TrackerState(
        ssm_state=n(state.ssm_state),
        am_state=AMState(template=n(am.template), p_am=n(am.p_am),
                         extra=tuple(n(x) for x in am.extra)),
        region=RegionState(norm_mat=n(rg.norm_mat), base_pts=n(rg.base_pts),
                           base_corners=n(rg.base_corners)),
        extra=LKCache(J0=n(ex.J0), H0=n(ex.H0),
                      coarse=tuple(tuple(n(x) for x in pack)
                                   for pack in ex.coarse)))
