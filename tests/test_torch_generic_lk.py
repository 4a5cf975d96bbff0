"""Port parity, the generic LK path (`mtf_tpu_torch/sm/lk.py` off the
chain kernel; `mtf_tpu/sm/lk.py:426-544` in the JAX package, which runs
it in XLA): the AM derivatives by `torch.func`, the patch Jacobian chain,
one iteration of every LK class under each Hessian flavour, the LM
damping's mean-|diag| floor, and the done masks of `epsilon > 0`.

The same inputs (a JAX-initialised single tracker, converted) go through
the JAX method and the port's; the JAX package runs its generic path
(`use_pallas=False`), each reference jitted (eager JAX compiles every
primitive on its first call) and all of them computed side by side first
(`test_torch_fleet.side_by_side`). Gradients, Hessians and steps agree
within 1e-4 of their norm, the north star's tolerance for g and H;
corners within 0.05 px.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.am import get_am as jget_am
from mtf_tpu.am.base import gn_hessian as jgn_hessian
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm.lk import _LKCarry
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.am import AMParams, gn_hessian, self_hessian
from mtf_tpu_torch.am import get_am as tget_am
from mtf_tpu_torch.parallel import TrackerFleet
from test_torch_fleet import (CORNER_TOL, CORNERS, _scene, jax_init,
                              side_by_side)

REL = 1e-4
CFG = dict(resx=16, resy=16, max_iters=5, epsilon=0.0, interp="linear")
SHIFT = (1, 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frames():
    frame = _scene()
    return frame, np.roll(frame, SHIFT, (0, 1))


# -- AM derivatives ----------------------------------------------------------

AM_CASES = [(key, c) for c in (1, 3, 5) for key in ("ssd", "ncc")]


def _am_inputs(c):
    rng = np.random.default_rng(c)
    n, s = 30, 4
    templ = rng.uniform(0, 255, (1, n, c)).astype(np.float32)
    patch = (templ + rng.normal(0, 8, templ.shape)).astype(np.float32)
    J = rng.normal(0, 1, (1, n * c, s)).astype(np.float32)
    return templ, patch, J


def _am_ref(jam, templ, patch, J):
    jst = jam.init(templ)
    return [jam.grad(jst, patch), jam.grad_template(jst, patch),
            jgn_hessian(jam, jst, patch, J),
            jgn_hessian(jam, jam.self_state(patch, jst.p_am), patch, J)]


@functools.cache
def _am_refs():
    """{(key, C): the JAX AM's grad, grad_template, GN and self Hessians}
    for every AM_CASES case, in one jit."""
    ins = [[x[0] for x in _am_inputs(c)] for _, c in AM_CASES]
    jams = [jget_am(key) for key, _ in AM_CASES]
    out = jax.jit(lambda ins: [_am_ref(j, *a) for j, a in zip(jams, ins)])(
        ins)
    return {case: [np.asarray(w) for w in o] for case, o in zip(AM_CASES,
                                                                 out)}


@pytest.mark.parametrize("key", ["ssd", "ncc"])
@pytest.mark.parametrize("c", [1, 3, 5])
def test_am_derivatives_match_jax(key, c):
    """grad, grad_template (through init: NCC's centred unit template),
    the Gauss-Newton and self Hessians of SSD and NCC on C-channel
    patches."""
    templ, patch, J = _am_inputs(c)
    tam = tget_am(key, AMParams())
    tst = tam.init(torch.tensor(templ))
    tp, tJ = torch.tensor(patch), torch.tensor(J)
    got = [tam.grad(tst, tp), tam.grad_template(tst, tp),
           gn_hessian(tam, tst, tp, tJ),
           self_hessian(tam, tp, tst.p_am, tJ)]
    for g, w in zip(got, _am_refs()[(key, c)]):
        assert _rel(g[0].numpy(), w) < REL


@pytest.mark.parametrize("key", ["ssd", "ncc"])
def test_am_update_model_matches_jax(key):
    """Template learning at learning_rate 0.3: the forgotten template
    (NCC: and its centred unit template) as the JAX package's."""
    from dataclasses import replace
    from mtf_tpu.am.base import AMParams as JAMParams
    rng = np.random.default_rng(7)
    templ = rng.uniform(0, 255, (1, 40, 2)).astype(np.float32)
    patch = rng.uniform(0, 255, (1, 40, 2)).astype(np.float32)
    jam = jget_am(key, replace(JAMParams(), learning_rate=0.3))
    tam = tget_am(key, AMParams(learning_rate=0.3))
    assert tam.needs_update_model and jam.needs_update_model
    got = tam.update_model(tam.init(torch.tensor(templ)), torch.tensor(patch))
    want = jax.jit(lambda t, p: jam.update_model(jam.init(t), p))(
        templ[0], patch[0])
    np.testing.assert_allclose(got.template[0].numpy(), want.template,
                               atol=1e-4, rtol=0)
    for g, w in zip(got.extra, want.extra):
        np.testing.assert_allclose(g[0].numpy(), w, atol=1e-6, rtol=0)


# -- the patch Jacobian chain -------------------------------------------------

@functools.cache
def _init(am, ssm, res):
    """A JAX single-tracker init state on the test scene, and its
    converted twin. Without coarse phases neither the LK class nor the
    Hessian flavour nor LM enters `initialize`
    (`mtf_tpu/sm/lk.py:244-296`), so FCLK's serves every class."""
    jsm = jcreate("fclk", am, ssm, **dict(CFG, resx=res, resy=res))
    jst = jax.jit(jsm.initialize)(_frames()[0], CORNERS[0])
    jst = jax.tree.map(np.asarray, jst)
    return jst, convert.to_torch(jst, device="cpu")


def _pair(key, am, ssm, **kw):
    """(JAX tracker, port tracker, JAX single-tracker init state, the
    port's converted twin), generic path on both."""
    cfg = {**CFG, **kw}
    jsm = jcreate(key, am, ssm, use_pallas=False, **cfg)
    tsm = tcreate(key, am, ssm, device="cpu", use_pallas=False, **cfg)
    return (jsm, tsm) + _init(am, ssm, cfg["resx"])


def _perturbed(jst):
    rng = np.random.default_rng(5)
    return np.asarray(jst.ssm_state) + rng.normal(
        0, 1e-3, jst.ssm_state.shape).astype(np.float32)


PJ_SSMS = ("8", "spline")


def _patch_and_jac_ref(jsm, jst, s, f2):
    jp, jJ = jsm._patch_and_jac(jst.region, s, jst.am_state.p_am, f2)
    return jp, jJ, jsm._hess_contract(jst.am_state, jp, jJ)


@functools.cache
def _patch_and_jac_refs():
    """{SSM: the JAX patch, its Jacobian and their Hessian contraction at
    a perturbed init state on the shifted frame}, in one jit."""
    pairs = [_pair("fclk", "ssd", ssm) for ssm in PJ_SSMS]
    out = jax.jit(lambda args, f2: [
        _patch_and_jac_ref(p[0], jst, s, f2)
        for p, (jst, s) in zip(pairs, args)])(
        [(p[2], _perturbed(p[2])) for p in pairs], _frames()[1])
    return {ssm: [np.asarray(w) for w in o] for ssm, o in zip(PJ_SSMS, out)}


@pytest.mark.parametrize("ssm", PJ_SSMS)
def test_patch_and_jac_and_hess_contract_match_jax(ssm):
    _, tsm, jst, tst = _pair("fclk", "ssd", ssm)
    s = _perturbed(jst)
    jp, jJ, jH = _patch_and_jac_refs()[ssm]
    tp, tJ = tsm._patch_and_jac(tst.region, torch.tensor(s[None]),
                                tst.am_state.p_am, torch.tensor(_frames()[1]),
                                None)
    assert _rel(tp[0].numpy(), jp) < REL and _rel(tJ[0].numpy(), jJ) < REL
    tH = tsm._hess_contract(tst.am_state, tp, tJ)
    assert _rel(tH[0].numpy(), jH) < REL


# -- one generic iteration ----------------------------------------------------

ITER_CASES = [(k, am, h) for k, am in [("fclk", "ssd"), ("iclk", "ssd"),
                                       ("esm", "ncc"), ("aesm", "ssd"),
                                       ("falk", "ncc"), ("ialk", "ssd"),
                                       ("fcsd", "ssd")]
              for h in ("self0", "selft", "std")] + [("fclk", "ssd", "std2")]
LM_CASES = [("eslm", "ncc"), ("iclm", "ssd")]


def _iter_kw(key, hess):
    kw = {"hess_type": hess}
    if key == "esm":
        kw["jac_type"] = "diff_of_jacs"
    return kw


def _iter_cases():
    """Every iteration reference's (key, AM, options): ITER_CASES' and
    the LM floor's."""
    return ([(k, am, tuple(sorted(_iter_kw(k, h).items())))
             for k, am, h in ITER_CASES]
            + [(k, am, (("hess_type", "selft"),)) for k, am in LM_CASES])


def _jax_step(jsm, key, jst, jc, f2):
    """JAX's dq of one iteration (for FCSD the step it intends, built from
    its own patch function, Jacobian and gradient)."""
    if key != "fcsd":
        return jsm._iteration(jst, f2, jc)[0]
    fn = jsm._patch_fn(jst.region, jc.ssm_state, jc.p_am, f2)
    q = jsm._q_dim
    j = jsm.am.grad_corrected(jst.am_state, fn(jnp.zeros(q))).reshape(
        -1) @ jsm._jac(fn, q)
    return jsm.prm.sd_learning_rate * j


ITER_CHUNKS = 3


@functools.cache
def _iteration_refs(chunk=None):
    """{case: the JAX package's dq of one iteration from the init state on
    the shifted frame} for every `_iter_cases` case (or every
    ITER_CHUNKS-th from `chunk`), each chunk in one jit (one compile of
    several iterations costs less than their compiles one by one; the
    chunks compile side by side)."""
    if chunk is None:
        return {c: d for i in range(ITER_CHUNKS)
                for c, d in _iteration_refs(i).items()}
    cases, steps, args = _iter_cases()[chunk::ITER_CHUNKS], [], []
    for key, am, kw in cases:
        jsm, _, jst, _ = _pair(key, am, "8", **dict(kw))
        delta = 1.0 if jsm.prm.enable_lm else 0.0
        args.append((jst, _LKCarry(
            jnp.asarray(jst.ssm_state), jnp.asarray(jst.am_state.p_am),
            jnp.int32(0), jnp.asarray(False), jnp.float32(delta),
            jnp.float32(-jnp.inf))))
        steps.append(functools.partial(_jax_step, jsm, key))
    out = jax.jit(lambda args, f2: [f(*a, f2) for f, a in zip(steps, args)])(
        args, _frames()[1])
    return {c: np.asarray(o) for c, o in zip(cases, out)}


def _iterate(key, am, **kw):
    """dq of one iteration from the init state on the shifted frame: the
    port's, and the JAX package's (`_iteration_ref`)."""
    _, tsm, _, tst = _pair(key, am, "8", **kw)
    want = _iteration_refs()[(key, am, tuple(sorted(kw.items())))]
    delta = 1.0 if tsm.prm.enable_lm else None
    img = torch.tensor(_frames()[1])
    ph = tsm._phases(tst, tst.extra._replace(coarse=()), [img], None, [])[-1]
    tc = lk_mod._Carry(tst.ssm_state, tst.am_state.p_am, 0,
                       torch.zeros(1, dtype=torch.bool),
                       None if delta is None else torch.full((1,), delta),
                       None)
    return tsm._iteration(tst, tc, ph, None)[0].numpy(), want


@pytest.mark.parametrize("key,am,hess", ITER_CASES)
def test_one_generic_iteration_matches_jax(key, am, hess):
    got, want = _iterate(key, am, **_iter_kw(key, hess))
    assert np.isfinite(got).all() and _rel(got, want) < REL


@pytest.mark.parametrize("key,am", LM_CASES)
def test_generic_lm_floor_matches_jax(key, am):
    """At lm_delta 1 the step is the JAX package's generic one, damped by
    diag(|H_ii| + mean |H_ii|) (`mtf_tpu/sm/lk.py:527-528`), not by the
    fused path's Marquardt diag(|H_ii|) alone."""
    got, want = _iterate(key, am, hess_type="selft")
    assert _rel(got, want) < REL
    _, tsm, _, _ = _pair(key, am, "8", hess_type="selft")
    assert tsm.prm.enable_lm


# -- done masks ------------------------------------------------------------

@functools.cache
def _freeze_case():
    """Two trackers, the second's region moved by a sub-pixel shift: the
    frames, corners, configuration and the JAX fleet's corners after one
    update."""
    frame = _scene()
    # the right part moves by a sub-pixel (0.6, 0.3) shift (bilinear):
    # an integer shift puts the template's points on pixel centres, where
    # the linear rule's one-sided derivative makes both packages' steps
    # depend on how the projection rounds (ROADMAP Queue 3, item 2)
    ax, ay = 0.6, 0.3
    sh = ((1 - ax) * (1 - ay) * frame + ax * (1 - ay) * np.roll(frame, 1, 1)
          + (1 - ax) * ay * np.roll(frame, 1, 0)
          + ax * ay * np.roll(frame, (1, 1), (0, 1)))
    f2 = frame.copy()
    f2[:, 150:] = sh[:, 150:]
    corners = np.array([[[30, 40], [90, 40], [90, 100], [30, 100]],
                        [[200, 120], [260, 120], [260, 180], [200, 180]]],
                       np.float32)
    cfg = dict(CFG, max_iters=10, epsilon=0.01)
    jfl = JFleet(jcreate("fclk", "ssd", "8", **cfg))
    want = np.asarray(jfl.corners(jfl.update(jax_init(jfl, frame, corners),
                                             f2)))
    return frame, f2, corners, cfg, want


def test_done_mask_freezes_a_converged_tracker(monkeypatch):
    """epsilon > 0 on a frame where one tracker's region does not move:
    it converges in its first iterations and freezes, as in the JAX
    package's vmapped while loop, while the moving one runs on; both end
    where the JAX fleet ends."""
    frame, f2, corners, cfg, want = _freeze_case()
    iters = []
    step = lk_mod.LKBase._step

    def spy(self, *a, **k):
        c = step(self, *a, **k)
        iters.append(c.it.clone())
        return c

    monkeypatch.setattr(lk_mod.LKBase, "_step", spy)
    fl = TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", **cfg))
    got = fl.corners(fl.update(fl.initialize(frame, corners), f2)).numpy()
    assert np.abs(got - want).max() < CORNER_TOL
    final = iters[-1].tolist()
    assert final[0] < final[1] and len(iters) == final[1], final


@functools.cache
def _masked_leg():
    """fclm with done masks and two coarse phases on a 2-update leg, the
    JAX fleet's corners per update."""
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    corners = (CORNERS + np.float32([0.31, 0.27])).astype(np.float32)
    frames, _ = synthetic_sequence(_scene(), corners,
                                   get_ssm("8", device="cpu"), n_frames=3,
                                   sigma_scale=0.004, seed=4)
    frames = frames.numpy()
    cfg = dict(resx=24, resy=24, max_iters=10, epsilon=0.05,
               interp="linear_mm", crop=96, coarse_pt_iters=((4, 3), (2, 3)))
    jfl = JFleet(jcreate("fclm", "ssd", "8", **cfg))
    st, want = jax_init(jfl, frames[0], corners), []
    for t in (1, 2):
        st = jfl.update(st, frames[t])
        want.append(np.asarray(jfl.corners(st)))
    return frames, corners, cfg, want


@pytest.mark.parametrize("use_pallas", [False, None])
def test_done_masks_through_coarse_phases_match_jax(use_pallas):
    """LM with done masks through two coarse phases, on the generic path
    and on the chain kernel: a tracker done in a coarse phase stays frozen
    until the full-resolution phase re-arms it and resumes from its own
    iteration count, as in the JAX package; corners within 0.05 px."""
    frames, corners, cfg, want = _masked_leg()
    fl = TrackerFleet(tcreate("fclm", "ssd", "8", device="cpu",
                              use_pallas=use_pallas, **cfg))
    assert fl.sm._fused_ok(types.SimpleNamespace(spi_mask=None),
                           torch.tensor(frames[0])) == (use_pallas is None)
    st = fl.initialize(frames[0], corners)
    for t in (1, 2):
        st = fl.update(st, frames[t])
        assert np.abs(fl.corners(st).numpy() - want[t - 1]).max() < \
            CORNER_TOL, t



@pytest.fixture(scope="module", autouse=True)
def _jax_refs():
    """Every JAX reference of this module, computed side by side first:
    the init states, then the AM derivatives, the patch Jacobians, the
    iterations and the fleets, PyTorch pinned to one thread meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    side_by_side([functools.partial(_init, am, ssm, CFG["resx"])
                  for am, ssm in (("ssd", "8"), ("ncc", "8"),
                                  ("ssd", "spline"))])
    side_by_side([_masked_leg]
                 + [functools.partial(_iteration_refs, i)
                    for i in range(ITER_CHUNKS)]
                 + [_freeze_case, _patch_and_jac_refs, _am_refs])
    yield
    torch.set_num_threads(n)
