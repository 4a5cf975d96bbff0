"""Carry tracker state between the JAX package and the port.

`to_torch` takes the JAX package's FCLK, ESM, grid (any flow, Median
Flow included), sub-tracker grid, RKLT, cascade, parallel or pyramidal
tracker state (any ported AM and matrix SSM; PF and NN; composites
nested in composites too) as a pytree of numpy arrays
(for example `jax.tree.map(np.asarray, state)` or a loaded checkpoint)
for one tracker or a vmapped batch, and returns the port's batched state
on a device (None: the card). `to_numpy` goes back: it returns the port's
NamedTuples holding numpy arrays laid out as the JAX package lays them
out, so the JAX NamedTuples can be rebuilt field by field. Fields are
read by name; nothing of JAX is imported.

Layouts (JAX per tracker -> port, B leading; C channels, 1 for gray,
3 for mcssd; the tap kind of `interp` changes none of them):
  ssm_state (S,) -> (B, S); am_state.template (N, C) -> (B, N, C);
  am_state.p_am (0,) -> (B, 0); am_state.extra () for SSD, SSIM and
  SPSS, (n0 (N, 1),) for NCC, (w0 (C, N, n_bins),) for MI and CCRE,
  (p0 (C, n_bins),) for KLD, (p0 (k·k, C, n_bins),) for LKLD -> batched;
  region.norm_mat (3, 3), base_pts (N, 2),
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
  only for an 8-DOF refiner, taken for the homography;
  PF extra (`PFState`): particles, prev_particles (P, S), log_weights
  (P,), distr_log_w (D,), am_particles (P, 0) and score_am (an AM state
  of the decimated grid, or None) -> batched; NN extra (`NNState`): feats
  (K, D), feats_sq (K,), dps (K, S) -> batched, ptr and frame_idx ()
  int32 -> (B,) int32, graph (K, k) int32 (or None) -> (B, K, k) int64.
  Their `key` becomes `step` as the grid's does;
  the AM extras of slice 10 -> batched, each leaf as above: NGF (g0
  (N, C, 2),), DFM (f0 (N, F),), PCA (mean (D,), basis (D, K), buffer
  (batch, D), count () int32 -> (B,) int32), SumOfAMs (its two AM states,
  converted alike); an ILM's p_am (P,) -> (B, P);
  LP extra (`LPState`): A (n_stages, S, N·C), patch0 (N, C) -> batched;
  RegNet extra (`RegNetState`): params, per layer (W (in, out), b (out,)),
  feat0 (D,), feat_scale () -> batched; the line tracker's extra is a
  grid's.

The box trackers' states (`box_to_torch`, which `to_torch` calls for a
state with a `center`) are read by their fields, each batched
(B leading) with the tracker's tables built by the port from the same
seed (RCT's measurement matrix, TLD's fern pairs): MOSSEState (center,
base_sz (2,), scale (), num (res, res, C) complex64, den (res, res),
psr ()), KCFState (alpha_f (res, res) complex64, model_x (res, res, C)),
DSSTState (also snum (S, D) complex64, sden (S,)), RCTState (mu_pos,
sg_pos, mu_neg, sg_neg (K,)), MILState (also sel (K,) int32 -> int64),
BoostState (also alpha (K,)), StruckState (sv_x (budget, D), sv_beta,
sv_pos, sv_valid (budget,); its `key`, never split in the JAX package,
becomes `step`, 0), FragState (templ_hists (F, n_bins)) and TLDState
(trk, the Median Flow leg's grid state, converted as above; valid ()
bool, var_min (), fern_pos and fern_neg (T, 2^F), pos_set (KP, P),
pos_valid (KP,), neg_set (KN, P), neg_valid (KN,), pos_ptr and neg_ptr
() int32). DFT's state is its inner tracker's.

The OpenCV trackers: the feature tracker's extra (`FeatureState`: desc0
(Kmax, D), pts0_t (Kmax, 2), valid0 (Kmax,) bool) -> batched, its `key`
becoming `step` as the grid's does; CMT's state (`CMTState`: center
(2,), scale, rot (), base_sz (2,), kp_rel (K, 2), kp_desc (K, D),
kp_valid (K,), bg_desc (KB, D), bg_valid (KB,), active_pos (K, 2),
active_ok (K,) bool) -> batched, and its prev_frame (H, W), B equal
copies in a vmapped JAX state, -> the one frame the port's trackers
share (`to_numpy` gives the B copies back as a broadcast view).
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch import _device
from mtf_tpu_torch.am.base import AMState
from mtf_tpu_torch.sm.cf import DSSTState, KCFState, MOSSEState
from mtf_tpu_torch.sm.cmt import CMTState
from mtf_tpu_torch.sm.composite import (RKLT, CascadeSM, CompositeState,
                                        ParallelSM, PyramidalSM)
from mtf_tpu_torch.sm.core import RegionState, TrackerState, image_corners
from mtf_tpu_torch.sm.feature import FeatureState
from mtf_tpu_torch.sm.grid import GridState, SubGridState
from mtf_tpu_torch.sm.learn import (BoostState, FragState, MILState, RCTState,
                                    StruckState)
from mtf_tpu_torch.sm.lk import LKCache
from mtf_tpu_torch.sm.lp import LPState
from mtf_tpu_torch.sm.nn import NNState
from mtf_tpu_torch.sm.pf import PFState
from mtf_tpu_torch.sm.regnet import RegNetState
from mtf_tpu_torch.sm.tld import TLDState
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


# the box trackers' states, told apart by a field of their own (the most
# specific first)
_BOX_STATES = (("kp_rel", CMTState), ("fern_pos", TLDState),
               ("snum", DSSTState),
               ("alpha_f", KCFState), ("num", MOSSEState),
               ("sv_x", StruckState), ("templ_hists", FragState),
               ("alpha", BoostState), ("sel", MILState),
               ("mu_pos", RCTState))


def box_to_torch(jstate, device=None, sm=None):
    """A JAX box tracker's state (CF, learn or TLD; single or batched) ->
    the port's batched state (see the module doc)."""
    single = np.ndim(jstate.center) == 1
    device = _device.resolve(device)
    cls = next(c for f, c in _BOX_STATES if hasattr(jstate, f))

    def leaf(name, x):
        a = np.asarray(x)
        if single:
            a = a[None]
        if np.iscomplexobj(a):
            return torch.tensor(a.astype(np.complex64), device=device)
        if a.dtype == np.bool_:
            return torch.tensor(a, device=device)
        if name == "sel":
            return torch.tensor(a, dtype=torch.int64, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, dtype=torch.int32, device=device)
        return torch.tensor(a.astype(np.float32), device=device)

    out = {}
    for name in cls._fields:
        if name == "step":
            out[name] = torch.zeros((), dtype=torch.int64)
        elif name == "trk":
            out[name] = to_torch(jstate.trk, device,
                                 None if sm is None else sm.mf)
        elif name == "prev_frame":
            out[name] = torch.tensor(_one_frame(jstate.prev_frame, single),
                                     device=device)
        elif name == "extra":
            out[name] = tuple(jstate.extra)
        else:
            out[name] = leaf(name, getattr(jstate, name))
    return cls(**out)


def to_torch(jstate, device=None, sm=None):
    """JAX-layout numpy state (single or batched) -> port state; `sm`,
    the port's tracker, tells composites apart (see the module doc)."""
    if hasattr(jstate, "center"):
        return box_to_torch(jstate, device, sm)
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

    def ints(x, dtype):
        a = np.asarray(x)
        return torch.tensor(a[None] if single else a, dtype=dtype,
                            device=device)

    def am_leaf(x, f):
        if hasattr(x, "template"):
            return am_state(x, f)
        if np.issubdtype(np.asarray(x).dtype, np.integer):
            return f(x).to(torch.int32)
        return f(x)

    def am_state(am, f=t):
        return AMState(template=f(am.template), p_am=f(am.p_am),
                       extra=tuple(am_leaf(x, f) for x in am.extra))

    def extra_of(ex, f=t):
        if hasattr(ex, "desc0"):
            return FeatureState(desc0=t(ex.desc0), pts0_t=t(ex.pts0_t),
                                valid0=ints(ex.valid0, torch.bool),
                                step=torch.zeros((), dtype=torch.int64))
        if hasattr(ex, "patch0"):
            return LPState(A=f(ex.A), patch0=f(ex.patch0))
        if hasattr(ex, "feat0"):
            return RegNetState(
                params=tuple((f(w), f(b)) for w, b in ex.params),
                feat0=f(ex.feat0), feat_scale=f(ex.feat_scale))
        if hasattr(ex, "particles"):
            return PFState(
                particles=t(ex.particles), prev_particles=t(ex.prev_particles),
                log_weights=t(ex.log_weights),
                step=torch.zeros((), dtype=torch.int64),
                distr_log_w=t(ex.distr_log_w),
                am_particles=t(ex.am_particles),
                score_am=(None if ex.score_am is None
                          else am_state(ex.score_am)))
        if hasattr(ex, "feats"):
            return NNState(
                feats=t(ex.feats), feats_sq=t(ex.feats_sq), dps=t(ex.dps),
                ptr=ints(ex.ptr, torch.int32),
                frame_idx=ints(ex.frame_idx, torch.int32),
                step=torch.zeros((), dtype=torch.int64),
                graph=(None if ex.graph is None
                       else ints(ex.graph, torch.int64)))
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
        rg = js.region
        return TrackerState(
            ssm_state=f(js.ssm_state),
            am_state=am_state(js.am_state, f),
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
    batch axis of a one-tracker state (a box tracker's state keeps the
    port's fields: Struck's `step`, MIL's and Boosting's int64 `sel`)."""
    def n(x):
        a = x.detach().cpu().numpy()
        return a[0] if squeeze else a

    def am_state(am, f=n):
        return AMState(template=f(am.template), p_am=f(am.p_am),
                       extra=tuple(am_state(x, f) if isinstance(x, AMState)
                                   else f(x) for x in am.extra))

    def extra_of(ex, f=n):
        if isinstance(ex, FeatureState):
            return FeatureState(desc0=n(ex.desc0), pts0_t=n(ex.pts0_t),
                                valid0=n(ex.valid0), step=ex.step.numpy())
        if isinstance(ex, LPState):
            return LPState(A=f(ex.A), patch0=f(ex.patch0))
        if isinstance(ex, RegNetState):
            return RegNetState(
                params=tuple((f(w), f(b)) for w, b in ex.params),
                feat0=f(ex.feat0), feat_scale=f(ex.feat_scale))
        if isinstance(ex, PFState):
            return ex._replace(**{k: (am_state(v) if isinstance(v, AMState)
                                      else v.numpy() if k == "step"
                                      else n(v))
                                  for k, v in ex._asdict().items()
                                  if v is not None})
        if isinstance(ex, NNState):
            return ex._replace(**{k: v.numpy() if k == "step" else n(v)
                                  for k, v in ex._asdict().items()
                                  if v is not None})
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
        if hasattr(st, "center"):
            def box_leaf(k, v):
                if k == "trk":
                    return tracker(v)
                if k == "step":
                    return v.numpy()
                if k == "extra":
                    return v
                if k == "prev_frame":
                    # CMT's one shared frame, as the B copies of a vmapped
                    # JAX state
                    a = v.detach().cpu().numpy()
                    return a if squeeze else np.broadcast_to(
                        a, (st.center.shape[0],) + a.shape)
                return n(v)
            return st._replace(**{k: box_leaf(k, v)
                                  for k, v in st._asdict().items()})
        if isinstance(st, CompositeState):
            return CompositeState(tuple(tracker(m) for m in st.members),
                                  extra=tuple(n(x) for x in st.extra))
        rg = st.region
        return TrackerState(
            ssm_state=f(st.ssm_state),
            am_state=am_state(st.am_state, f),
            region=RegionState(norm_mat=f(rg.norm_mat),
                               base_pts=f(rg.base_pts),
                               base_corners=f(rg.base_corners)),
            extra=extra_of(st.extra, f))

    return tracker(state)
