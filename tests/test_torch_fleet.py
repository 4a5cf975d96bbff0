"""Port parity, the whole slice: a fleet of FCLK + SSD + homography
trackers in the benchmark's configuration (50x50 templates, 10
iterations as 6 + 3 + 1 coarse-to-fine, dense linear sampling from a
144-px window), stepped by `mtf_tpu_torch` and by the JAX package on the
same frames. Corners must agree within 0.05 px, the chain kernel's
parity tolerance in the JAX package's own tests."""
import jax
import numpy as np
import pytest
import torch

import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.utils import synth as tsynth

CFG = dict(resx=50, resy=50, max_iters=10, epsilon=0.0, interp="linear_mm",
           crop=144, coarse_pt_iters=((4, 6), (2, 3)))
CORNER_TOL = 0.05
CORNERS = np.array([[[110, 80], [170, 80], [170, 140], [110, 140]],
                    [[40, 30], [118, 36], [112, 110], [36, 104]],
                    [[200, 120], [290, 128], [286, 210], [204, 200]]],
                   np.float32)


def _scene(seed=1, h=240, w=320):
    """Smooth random scene. The rendered frames sample at float32
    coordinates that carry ~3e-5 px of rounding at x ~ 300, and the two
    packages round differently (3x3 inverse, matmul order); times the
    scene's steepest gradient that is the frames' disagreement. This
    seed's scene peaks at 19 levels/px, which keeps it under the 1e-3
    bound (6.3e-4 measured); seed 0's peaks at 42 levels/px and reaches
    2.0e-3 on 9 of 307,200 pixels."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def _jax_fleet(use_pallas):
    return JFleet(jcreate("fclk", "ssd", "8", use_pallas=use_pallas, **CFG))


@pytest.fixture(scope="module")
def ref():
    """The JAX runs every test compares against, computed once: one
    update on both JAX paths (generic XLA, and the Pallas chain kernel in
    interpret mode) and a 4-frame synthetic GT leg on the generic path."""
    frame = _scene()
    f2 = np.roll(frame, (3, 2), (0, 1))
    out = {"frame": frame, "f2": f2}
    for name, use_pallas in (("generic", None), ("pallas", True)):
        fl = _jax_fleet(use_pallas)
        st0 = fl.initialize(frame, CORNERS)
        out[name] = np.asarray(fl.corners(fl.update(st0, f2)))
        if name == "generic":
            out["state0"] = jax.tree.map(np.asarray, st0)
            gfl = fl
    frames, gt = jsynth.synthetic_sequence(
        frame, CORNERS, gfl.sm.ssm, n_frames=4, sigma_scale=0.004, seed=3)
    frames = np.asarray(frames)
    st = gfl.initialize(frames[0], CORNERS)
    leg = []
    for t in range(1, len(frames)):
        st = gfl.update(st, frames[t])
        leg.append(np.asarray(gfl.corners(st)))
    out.update(frames=frames, gt=gt, leg=np.stack(leg))
    return out


def _port_fleet(donate=False):
    return TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", **CFG),
                        donate=donate)


@pytest.mark.parametrize("jax_path", ["generic", "pallas"])
def test_one_update_matches_jax(ref, jax_path):
    fl = _port_fleet()
    st = fl.update(fl.initialize(ref["frame"], CORNERS), ref["f2"])
    got = fl.corners(st).numpy()
    assert np.abs(got - ref[jax_path]).max() < CORNER_TOL


def test_update_runs_ten_chain_iterations(ref, monkeypatch):
    """6 + 3 coarse iterations and 1 full-resolution one, each one call
    of the chain kernel wrapper (which counts launches only on CUDA)."""
    fl = _port_fleet()
    st = fl.initialize(ref["frame"], CORNERS)
    calls = []

    def spy(window, M0, gens, ph, templ, **kw):
        calls.append(ph.shape[-1])
        return lk_fused_chain(window, M0, gens, ph, templ, **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    fl.update(st, ref["f2"])
    assert calls == [169] * 6 + [625] * 3 + [2500]


def test_synthetic_frames_match(ref):
    ssm = tcreate("fclk", "ssd", "8", device="cpu", **CFG).ssm
    frames, gt = tsynth.synthetic_sequence(
        ref["frame"], CORNERS, ssm, n_frames=4, sigma_scale=0.004, seed=3)
    np.testing.assert_allclose(frames.numpy(), ref["frames"], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(gt, ref["gt"], atol=1e-3, rtol=0)


def test_synthetic_noise_and_drift_match():
    """Noise is drawn from the same numpy generator after the warp
    steps, and gain/bias drift apply per frame, in both packages."""
    img = _scene(2, 48, 64)
    corners = np.array([[20, 12], [44, 12], [44, 36], [20, 36]], np.float32)
    kw = dict(n_frames=3, sigma_scale=0.01, seed=5, noise_sigma=2.0,
              gain_drift=0.05, bias_drift=1.5)
    jf, jgt = jsynth.synthetic_sequence(img, corners,
                                        jcreate("fclk", "ssd", "8").ssm, **kw)
    ssm = tcreate("fclk", "ssd", "8", device="cpu", **CFG).ssm
    tf, tgt = tsynth.synthetic_sequence(img, corners, ssm, **kw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tgt, jgt, atol=1e-3, rtol=0)


def test_gt_leg_matches_jax_per_frame(ref):
    fl = _port_fleet()
    frames = ref["frames"]
    st = fl.initialize(frames[0], CORNERS)
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - ref["leg"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - ref["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


def test_convert_round_trip_and_update(ref):
    """A JAX-initialised state, converted and updated by the port, gives
    the JAX update; converting back gives the JAX state unchanged."""
    jst = ref["state0"]
    tst = convert.to_torch(jst, device="cpu")
    back = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(
            (jst.ssm_state, jst.am_state, jst.region, jst.extra))):
        np.testing.assert_array_equal(a, b)
    fl = _port_fleet()
    got = fl.corners(fl.update(tst, ref["f2"])).numpy()
    assert np.abs(got - ref["generic"]).max() < CORNER_TOL


def test_convert_single_tracker(ref):
    one = jax.tree.map(lambda x: x[0], ref["state0"])
    tst = convert.to_torch(one, device="cpu")
    assert tst.ssm_state.shape == (1, 8)
    assert tst.extra.coarse[0][0].shape == (1, 169)
    back = convert.to_numpy(tst, squeeze=True)
    np.testing.assert_array_equal(back.region.base_pts, one.region.base_pts)


def test_donate_updates_state_in_place(ref):
    fl, fl_d = _port_fleet(), _port_fleet(donate=True)
    want = fl.update(fl.initialize(ref["frame"], CORNERS), ref["f2"])
    st = fl_d.initialize(ref["frame"], CORNERS)
    ssm_buf = st.ssm_state
    out = fl_d.update(st, ref["f2"])
    assert out is st and out.ssm_state is ssm_buf
    assert torch.equal(out.ssm_state, want.ssm_state)


@pytest.mark.parametrize("args,kw", [
    (("esm", "ncc", "8"), {}),
    (("fclk", "ncc", "8"), {}),
    (("fclk", "ssd", "2"), {}),
    (("rklt", "ssd", "8"), {}),
    (("fclk", "ssd", "8"), {**CFG, "interp": "linear"}),
    (("fclk", "ssd", "8"), {**CFG, "epsilon": 0.01}),
    (("fclk", "ssd", "8"), {**CFG, "hess_type": "self0"}),
    (("fclk", "ssd", "8"), {**CFG, "border": "constant"}),
    (("fclk", "ssd", "8"), {**CFG, "use_pallas": True}),
])
def test_factory_rejects_unported(args, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcreate(*args, device="cpu", **kw)
