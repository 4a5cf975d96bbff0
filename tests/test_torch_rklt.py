"""Port parity, slice 3 as a whole: a fleet of RKLT trackers (the grid
tracker with RANSAC, refined by ESM-LM + SSD) in the bench row's
configuration (`bench_extra.py:363-379`), stepped by `mtf_tpu_torch` and
by the JAX package (the Pallas kernels in interpret mode) on the same
frames, with the JAX package's RANSAC index draws handed to the port.
Corners must agree within 0.05 px, the chain kernel's parity tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm.composite import CompositeState as JCompositeState
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops.kernels import grid_flow as gf
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm import grid as tgrid
from mtf_tpu_torch.sm.composite import RKLT, CompositeState
from mtf_tpu_torch.sm.core import image_corners
from mtf_tpu_torch.sm.grid import GridTracker
from mtf_tpu_torch.sm.lk import ESM
from test_torch_fleet import CORNER_TOL, _scene
from test_torch_grid import GRID_CORNERS, jax_fit_indices, use_indices

RKLT_CFG = dict(resx=50, resy=50, max_iters=10, epsilon=0.0,
                interp="linear_mm", crop=160, grid_sub_iters=(1, 8),
                grid_coarse_stride=2, coarse_pt_iters=((4, 6), (2, 3)))
# The synthetic sequence's seed. On seed 3's sequence the JAX package's
# own two paths (XLA, Pallas) end the second frame 0.105 px apart, and
# the port sits between them (0.055 and 0.063 px): the refiner's LM
# steps there amplify float32 rounding, which would test rounding, not
# the port. On seed 4's the port and the Pallas path measured 0.0073 and
# 0.0040 px apart at frames 1 and 2.
SEQ_SEED = 4


@pytest.fixture(scope="module")
def ref():
    """Two JAX rklt updates (Pallas path, interpret mode) on a 3-frame
    synthetic sequence, computed once. The initial state gets a
    placeholder final-corner slot (RKLT.update never reads it), so both
    updates share one compiled step."""
    fl = JFleet(jcreate("rklt", "ssd", "8", use_pallas=True, **RKLT_CFG))
    frames, gt = jsynth.synthetic_sequence(
        _scene(0), GRID_CORNERS, fl.sm.ssm, n_frames=3, sigma_scale=0.004,
        seed=SEQ_SEED)
    frames = np.asarray(frames)
    st = fl.initialize(frames[0], GRID_CORNERS)
    out = {"frames": frames, "gt": gt, "states": [], "corners": [],
           "state0": jax.tree.map(np.asarray, st)}
    st = JCompositeState(st.members, (jnp.zeros(GRID_CORNERS.shape),))
    for t in (1, 2):
        st = fl.update(st, frames[t])
        out["states"].append(jax.tree.map(np.asarray, st))
        out["corners"].append(np.asarray(fl.corners(st)))
    return out


def _port(**kw):
    sm = tcreate("rklt", "ssd", "8", device="cpu", **{**RKLT_CFG, **kw})
    return sm


def test_rklt_matches_jax_per_frame(ref):
    """Each frame within 0.05 px of the JAX Pallas path, and within
    0.2 px of the exact ground truth on average."""
    sm = _port()
    use_indices(sm.grid_sm, jax_fit_indices(2))
    fl = TrackerFleet(sm)
    frames = ref["frames"]
    st = fl.initialize(frames[0], GRID_CORNERS)
    for t in (1, 2):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - ref["corners"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - ref["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


def test_rklt_update_runs_two_k5_and_ten_chain_calls(ref, monkeypatch):
    """Per update: the grid's two levels (one grid-flow call each), then
    the refiner's 6 + 3 + 1 iterations, each one chain call in SSD mode
    with ESM's J0 operand."""
    sm = _port()
    st = sm.initialize(ref["frames"][0], GRID_CORNERS)
    calls = []

    def k5_spy(win, pts, templ, scale, n, n_iters, zncc=True,
               kind="linear"):
        calls.append(("k5", n, n_iters))
        return gf.grid_flow(win, pts, templ, scale, n, n_iters, zncc, kind)

    def chain_spy(window, M0, gens, ph, templ, am="ssd", j0=None, **kw):
        calls.append(("chain", ph.shape[-1], am, j0 is not None))
        return lk_fused_chain(window, M0, gens, ph, templ, am=am, j0=j0,
                              **kw)

    monkeypatch.setattr(tgrid, "grid_flow", k5_spy)
    monkeypatch.setattr(lk_mod, "lk_fused_chain", chain_spy)
    sm.update(st, ref["frames"][1])
    assert calls == [("k5", 16, 8), ("k5", 64, 1)] + [
        ("chain", n, "ssd", True) for n in [169] * 6 + [625] * 3 + [2500]]


def test_rklt_falls_back_to_the_grid(ref):
    """A negative failure threshold marks every tracker diverged: the
    final corners are the grid's and the refiner is re-seated there."""
    sm = _port(rklt_failure_thresh=-1.0, rklt_feedback=False)
    st = sm.update(sm.initialize(ref["frames"][0], GRID_CORNERS),
                   ref["frames"][1])
    grid_st, templ_st = st.members
    grid_c = image_corners(sm.grid_sm.ssm, grid_st)
    assert torch.equal(st.extra[0], grid_c)
    want = sm.templ_sm.set_region(templ_st, grid_c).ssm_state
    assert torch.equal(templ_st.ssm_state, want)


def test_convert_round_trip_and_update(ref):
    """A JAX rklt state after one update, converted, gives back every
    field (the key aside: the port's counter starts at 0); updated by the
    port it gives the JAX second update."""
    jst = ref["states"][0]
    tst = convert.to_torch(jst, device="cpu")
    assert isinstance(tst, CompositeState)
    assert tst.members[0].extra.templates.shape == (2, 2, 100, 64, 1)
    assert int(tst.members[0].extra.step) == 0
    back = convert.to_numpy(tst)

    def leaves(s):
        g, t = s.members
        ge = g.extra
        return (jax.tree.leaves((g.ssm_state, g.am_state, g.region))
                + [ge.templates, ge.offsets, ge.centers0, ge.inlier_mask]
                + jax.tree.leaves((t.ssm_state, t.am_state, t.region,
                                   t.extra)) + list(s.extra))

    for a, b in zip(leaves(back), leaves(jst), strict=True):
        np.testing.assert_array_equal(a, b)
    sm = _port()
    use_indices(sm.grid_sm, jax_fit_indices(2)[1:])
    got = sm.corners(sm.update(tst, ref["frames"][2])).numpy()
    assert np.abs(got - ref["corners"][1]).max() < CORNER_TOL


def test_convert_initial_state_takes_the_refiner_corners(ref):
    """A JAX state straight from `initialize` has no final corners; the
    port's are the refiner's, the init corners."""
    tst = convert.to_torch(ref["state0"], device="cpu")
    np.testing.assert_allclose(tst.extra[0].numpy(), GRID_CORNERS, atol=1e-3)


def test_donate_updates_rklt_state_in_place(ref):
    """Donation writes every replaced tensor into the state passed in:
    both members' warps, the grid's counter and inlier mask and the
    final corners."""
    frames = ref["frames"]
    plain = TrackerFleet(_port())
    want = plain.update(plain.initialize(frames[0], GRID_CORNERS), frames[1])
    fl = TrackerFleet(_port(), donate=True)
    st = fl.initialize(frames[0], GRID_CORNERS)
    bufs = [st.members[0].ssm_state, st.members[1].ssm_state,
            st.members[0].extra.step, st.members[0].extra.inlier_mask,
            st.extra[0]]
    out = fl.update(st, frames[1])
    assert out is st
    got = [out.members[0].ssm_state, out.members[1].ssm_state,
           out.members[0].extra.step, out.members[0].extra.inlier_mask,
           out.extra[0]]
    new = [want.members[0].ssm_state, want.members[1].ssm_state,
           want.members[0].extra.step, want.members[0].extra.inlier_mask,
           want.extra[0]]
    for buf, g, w in zip(bufs, got, new):
        assert g is buf and torch.equal(g, w)


@pytest.mark.parametrize("key", ["rklt", "rkl", "lmes"])
def test_rklt_factory_keys(key):
    """Every JAX RKLT key builds a grid on an 8x8 SSD template and an
    ESM refiner with LM and the selft Hessian, with the JAX factory's
    parameters."""
    t = tcreate(key, "ssd", "8", device="cpu", **RKLT_CFG)
    j = jcreate(key, "ssd", "8", **RKLT_CFG)
    assert isinstance(t, RKLT) and isinstance(t.grid_sm, GridTracker)
    assert isinstance(t.templ_sm, ESM)
    assert (t.grid_sm.am.prm.resx, t.grid_sm.am.prm.resy) == (8, 8)
    assert t.templ_sm.prm.enable_lm and t.templ_sm.prm.hess_type == "selft"
    assert t.templ_sm.prm.enable_lm == j.templ_sm.prm.enable_lm
    for f in ("grid_res", "patch_res", "sub_iters", "coarse_point_stride",
              "estimator", "n_hyps", "inlier_thresh_px", "zncc",
              "pyramid_levels", "flow", "seed"):
        assert getattr(t.grid_sm.grid, f) == getattr(j.grid_sm.grid, f), f
    assert (t.prm.failure_thresh_px, t.prm.enable_feedback) == (
        j.prm.failure_thresh_px, j.prm.enable_feedback)


def test_rklt_defaults_to_the_card(monkeypatch):
    """Without `device` the rklt tracker resolves to the card, and raises
    where there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcreate("rklt", "ssd", "8", **RKLT_CFG)


def test_set_region_reports_the_new_corners(ref):
    """ROADMAP Queue 3, item 14, decided as a fault of the reference:
    after `set_region`, RKLT's `corners` are the new corners, as every
    search method's are in both packages (`set_region` refits the SSM
    state to them: MTF's `setRegion`, `ssm->setCorners`) and both members
    are there. The JAX package's RKLT keeps the previous final corners in
    `extra` (`mtf_tpu/sm/composite.py:231-235`), so its `corners` after
    an update and a `set_region` still read the update's."""
    new = (GRID_CORNERS + np.float32([3.3, -2.1])).astype(np.float32)
    sm = _port()
    st = sm.set_region(convert.to_torch(ref["states"][0], device="cpu",
                                        sm=sm), torch.as_tensor(new))
    np.testing.assert_allclose(sm.corners(st).numpy().transpose(0, 2, 1),
                               new, atol=1e-3)
    for m, ms in zip((sm.grid_sm, sm.templ_sm), st.members):
        np.testing.assert_allclose(image_corners(m.ssm, ms).numpy(), new,
                                   atol=1e-3)
    j = jcreate("rklt", "ssd", "8", **RKLT_CFG)
    jst = jax.vmap(j.set_region)(jax.tree.map(jnp.asarray, ref["states"][0]),
                                 jnp.asarray(new))
    np.testing.assert_array_equal(np.asarray(jax.vmap(j.corners)(jst)),
                                  ref["corners"][0])
