"""Port parity, slice 2: fleets of ESM and FCLK trackers with the NCC
and SSD appearance models on the chain kernel's NCC-moment and ESM modes,
and the Levenberg-Marquardt variant (`eslm`), stepped by `mtf_tpu_torch`
and by the JAX package on the same frames. Corners must agree within
0.05 px, the chain kernel's parity tolerance in the JAX package's own
tests, on both JAX paths (generic XLA, and the Pallas chain kernel in
interpret mode)."""
import functools

import jax
import numpy as np
import pytest
import torch

import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import _device, convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.ssm import get_ssm as tget_ssm
from test_torch_fleet import (CFG, CORNER_TOL, CORNERS, _scene,
                              builds_like_jax, jax_init, side_by_side)

# the configurations of tests/test_r5_features.py:36-50 (no coarse phases
# unless given: 10 full-resolution iterations)
R5 = dict(resx=50, resy=50, max_iters=10, epsilon=0.0, interp="linear_mm",
          crop=144)
R5_CASES = [("esm", "ncc", {}), ("fclk", "ncc", {}), ("esm", "ssd", {}),
            ("esm", "ncc", {"coarse_pt_iters": ((2, 4),)})]
R5_IDS = ["esm-ncc", "fclk-ncc", "esm-ssd", "esm-ncc-coarse2"]
# a shift from which every tracker converges within the 10 iterations:
# from the (3, 2) shift of test_torch_fleet, FCLK's first-order steps
# leave two trackers ~0.9 px short after 10 full-resolution iterations,
# and corners that far from their fixed point differ by up to 0.2 px
# between any two float32 implementations (the JAX package's own two
# paths included), so they would test rounding, not the port
R5_SHIFT = (2, 1)


def _frames():
    frame = _scene()
    return frame, np.roll(frame, R5_SHIFT, (0, 1))


@functools.cache
def _jax_r5_init(case: int):
    """The generic JAX fleet of a case and its init state, computed once:
    the Pallas path starts from the same state (`jax_init`)."""
    key, am, kw = R5_CASES[case]
    fl = JFleet(jcreate(key, am, "8", **R5, **kw))
    return fl, jax_init(fl, _frames()[0], CORNERS)


@functools.cache
def _jax_r5(case: int, use_pallas):
    """JAX corners (B, 2, 4) after one update, computed once per case and
    path."""
    key, am, kw = R5_CASES[case]
    fl, st0 = _jax_r5_init(case)
    if use_pallas is not None:
        fl = JFleet(jcreate(key, am, "8", use_pallas=use_pallas, **R5, **kw))
    return np.asarray(fl.corners(fl.update(st0, _frames()[1])))


@pytest.mark.parametrize("jax_path", ["generic", "pallas"])
@pytest.mark.parametrize("case", range(len(R5_CASES)), ids=R5_IDS)
def test_one_update_matches_jax(case, jax_path):
    key, am, kw = R5_CASES[case]
    frame, f2 = _frames()
    fl = TrackerFleet(tcreate(key, am, "8", device="cpu", **R5, **kw))
    got = fl.corners(fl.update(fl.initialize(frame, CORNERS), f2)).numpy()
    want = _jax_r5(case, None if jax_path == "generic" else True)
    assert np.abs(got - want).max() < CORNER_TOL


@pytest.fixture(scope="module")
def lm_ref():
    """eslm/ncc in the benchmark's configuration (coarse phases 6 + 3 + 1,
    LM on), computed once: its initial state and a 4-frame synthetic GT
    leg on the generic JAX path, and the first update on the Pallas path,
    the two compiles side by side."""
    frame = _scene()
    fl = JFleet(jcreate("eslm", "ncc", "8", **CFG))
    frames, gt = jsynth.synthetic_sequence(
        frame, CORNERS, fl.sm.ssm, n_frames=4, sigma_scale=0.004, seed=3)
    frames = np.asarray(frames)
    st0 = jax_init(fl, frames[0], CORNERS)
    out = {"frames": frames, "gt": gt,
           "state0": jax.tree.map(np.asarray, st0)}

    def leg():
        st, corners = st0, []
        for t in range(1, len(frames)):
            st = fl.update(st, frames[t])
            corners.append(np.asarray(fl.corners(st)))
        out["leg"] = np.stack(corners)

    def pallas():
        pfl = JFleet(jcreate("eslm", "ncc", "8", use_pallas=True, **CFG))
        out["pallas"] = np.asarray(pfl.corners(pfl.update(
            jax_init(fl, frames[0], CORNERS), frames[1])))

    side_by_side([leg, pallas])
    return out


def _lm_fleet():
    return TrackerFleet(tcreate("eslm", "ncc", "8", device="cpu", **CFG))


def test_eslm_update_matches_jax_pallas_path(lm_ref):
    fl = _lm_fleet()
    frames = lm_ref["frames"]
    got = fl.corners(fl.update(fl.initialize(frames[0], CORNERS),
                               frames[1])).numpy()
    assert np.abs(got - lm_ref["pallas"]).max() < CORNER_TOL


def test_eslm_gt_leg_matches_jax_per_frame(lm_ref):
    """Each frame of the leg within 0.05 px of the generic JAX path, and
    within 0.2 px of the exact ground truth on average."""
    fl = _lm_fleet()
    frames = lm_ref["frames"]
    st = fl.initialize(frames[0], CORNERS)
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - lm_ref["leg"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - lm_ref["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


# The port forms NCC's self Hessian in closed form from the chain
# kernel's moments (template == patch); the JAX package contracts its AD
# Hessian of NCC with the template Jacobian. Given the JAX state's own
# templates and Jacobians, measured on this scene: within 1.0e-5 of the
# Hessian's norm at full resolution and in both coarse phases; bound with
# 10x headroom. (Each package's own J0 differs in the rows of points
# that land exactly on an integer coordinate in one and not the other:
# the dense derivative is 0 there, see ROADMAP Queue 3.)
H0_REL = 1e-4


def test_ncc_h0_matches_jax_ad(lm_ref):
    sm = _lm_fleet().sm
    st = lm_ref["state0"]
    packs = [(st.am_state.template[..., 0], st.extra.H0, st.extra.J0)]
    packs += [(t, h, j) for t, h, j in st.extra.coarse]
    for patch, want, J in packs:
        got = sm._self_hessian(torch.tensor(patch), torch.tensor(J))
        for b in range(len(CORNERS)):
            err = float(np.abs(got[b].numpy() - want[b]).max())
            assert err <= H0_REL * np.linalg.norm(want[b]), err


def test_convert_round_trip_and_update(lm_ref):
    """A JAX-initialised eslm/ncc state (NCC's n0 in am_state.extra),
    converted and updated by the port, gives the JAX update; converting
    back gives the JAX state unchanged."""
    jst = lm_ref["state0"]
    tst = convert.to_torch(jst, device="cpu")
    assert tst.am_state.extra[0].shape == (len(CORNERS), 2500, 1)
    back = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(
            (jst.ssm_state, jst.am_state, jst.region, jst.extra))):
        np.testing.assert_array_equal(a, b)
    fl = _lm_fleet()
    got = fl.corners(fl.update(tst, lm_ref["frames"][1])).numpy()
    assert np.abs(got - lm_ref["leg"][0]).max() < CORNER_TOL


@pytest.mark.parametrize("key", ["esm", "eslm"])
def test_update_runs_ten_ncc_esm_iterations(key, monkeypatch):
    """6 + 3 coarse iterations and 1 full-resolution one, each one call
    of the chain kernel wrapper in NCC mode with ESM's J0 operand (LM adds
    no kernel call)."""
    frame = _scene()
    fl = TrackerFleet(tcreate(key, "ncc", "8", device="cpu", **CFG))
    st = fl.initialize(frame, CORNERS)
    calls = []

    def spy(window, M0, gens, ph, templ, am="ssd", j0=None, **kw):
        calls.append((ph.shape[-1], am, tuple(j0.shape)))
        return lk_fused_chain(window, M0, gens, ph, templ, am=am, j0=j0,
                              **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    fl.update(st, np.roll(frame, (3, 2), (0, 1)))
    b = len(CORNERS)
    assert calls == [(n, "ncc", (b, 8, n))
                     for n in [169] * 6 + [625] * 3 + [2500]]


@pytest.mark.parametrize("key", ["fclk", "fc", "fclm", "esm", "fesm",
                                 "esmh", "eslm", "esl"])
def test_factory_keys(key):
    """Every JAX key that maps to FCLK or ESM builds the same class, with
    LM on exactly where the JAX factory turns it on."""
    t = tcreate(key, "ncc", "8", device="cpu", **CFG)
    j = jcreate(key, "ncc", "8", **CFG)
    assert type(t).__name__ == type(j).__name__
    assert t.prm.enable_lm == j.prm.enable_lm


@pytest.mark.parametrize("args,kw", [
    (("esm", "ncc", "8"), {"jac_type": "diff_of_jacs"}),
    (("eslm", "ncc", "8"), {"epsilon": 0.01}),
    (("iclk", "ncc", "8"), {}),
    (("esm", "ncc", "8"), {"interp": "linear"}),
])
def test_factory_rejects_rest_of_slice_2(args, kw):
    """The rest of slice 2 (diff_of_jacs, done masks, ICLK, the gather
    interps) builds as the JAX package builds it, each on the path the
    JAX package's `_fused_ok` names (`test_torch_fleet.builds_like_jax`);
    the generic path's parity is `test_torch_generic_lk.py`'s and
    `test_torch_generic_fleet.py`'s."""
    builds_like_jax(args, {**CFG, **kw})


def test_entry_points_default_to_the_card(monkeypatch):
    """Without `device` the port resolves to the card, and raises where
    there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcreate("esm", "ncc", "8", **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tget_ssm("8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve(None) == torch.device("cuda")
    assert _device.resolve("cpu") == torch.device("cpu")
