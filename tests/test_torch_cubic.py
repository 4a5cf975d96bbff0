"""Port parity, slice 4 (cubic taps): the dense Catmull-Rom (`cubic_mm`)
and cubic B-spline (`cubic_bspl_mm`) samplers, the chain kernel's cubic
tap modes (K1c) and a fleet of FCLK + SSD + homography trackers on
`interp="cubic_mm"`, stepped by `mtf_tpu_torch` and by the JAX package on
the same frames. Corners must agree within 0.05 px on both JAX paths
(generic XLA, and the Pallas chain kernel in interpret mode).

The plain K1c is held against the JAX Pallas kernel in interpret mode
with its bf16 casts made float32 (`test_torch_mc.pallas_f32`), at small N
and window sizes, in every mode the trackers reach.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import interp as jinterp
from mtf_tpu.ops.pallas.dense_sample import _weights_dense as jweights
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp as tinterp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.ops.kernels.dense_sample import _weights_dense
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.utils import synth as tsynth
from test_torch_fleet import CFG, CORNER_TOL, CORNERS, _scene, jax_init
from test_torch_gpu import CUBIC_KINDS, all_mode_inputs
from test_torch_gpu import assert_norm_close
from test_torch_grid_family import pyr_flow_pair
from test_torch_mc import _t, pallas_f32

CUBIC_CFG = dict(CFG, interp="cubic_mm")
# the fleet parity runs' schedule: one coarse phase at stride 2 and 2
# full-resolution iterations; the JAX compile time grows with the phases,
# and the benchmark's 6 + 3 + 1 runs in
# `test_update_runs_ten_cubic_iterations` and on the card
FLEET_CFG = dict(CUBIC_CFG, max_iters=6, coarse_pt_iters=((2, 4),))


@pytest.mark.parametrize("kind", CUBIC_KINDS)
def test_weights_dense_matches_jax(kind):
    """phi and phi' on offsets across both branches and their joins
    (|t| = 0, 1, 2 exactly) within 1e-5 of the JAX package's; the cubic
    phi' is continuous at |t| = 1, where the linear one steps."""
    rng = np.random.default_rng(0)
    t = np.concatenate([rng.uniform(-2.5, 2.5, 400),
                        [0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -1.5]]
                       ).astype(np.float32)
    w, d = _weights_dense(torch.tensor(t), kind)
    jw, jd = jweights(jnp.asarray(t), kind)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    near = torch.tensor([1.0 - 1e-6, 1.0, 1.0 + 1e-6])
    assert float(_weights_dense(near, kind)[1].diff().abs().max()) < 1e-5


def _image01(rng, h=60, w=70, c=2):
    """A smooth c-channel image on [0, 1], so 1e-5 is a relative bound."""
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w, c)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


@pytest.mark.parametrize("crop", [None, 32])
@pytest.mark.parametrize("kind", CUBIC_KINDS)
def test_sample_dense_matches_jax(kind, crop):
    """Values and gradients of the gather-form cubic sampler within 1e-5
    of the JAX package's dense (matmul) form, edge, integer and
    out-of-window points included."""
    rng = np.random.default_rng(1)
    img = _image01(rng)
    pts = rng.uniform(-3, 73, (80, 2)).astype(np.float32)
    pts[:10] = np.round(pts[:10])
    v, g = tinterp.sample_dense(torch.tensor(img), torch.tensor(pts), kind,
                                crop=crop)
    jv, jg = jax.jit(lambda i, p: jinterp.sample_dense(
        i, p, kind, crop=crop, precision=jax.lax.Precision.HIGHEST))(
            jnp.asarray(img), jnp.asarray(pts))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", CUBIC_KINDS)
def test_sample_windows_matches_dense(kind):
    """Per-tracker (B, C, Hc, Wc) windows give what `sample_dense` gives
    on each (Hc, Wc, C) window, and a (B, Hc, Wc) window channel 0's."""
    rng = np.random.default_rng(2)
    win = torch.tensor(rng.uniform(0, 255, (2, 3, 20, 24)),
                       dtype=torch.float32)
    x = torch.tensor(rng.uniform(-2, 26, (2, 40)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(-2, 22, (2, 40)), dtype=torch.float32)
    v, dx, dy = tinterp.sample_windows(win, x, y, need_grad=True, kind=kind)
    for b in range(2):
        want, g = tinterp.sample_dense(win[b].permute(1, 2, 0),
                                       torch.stack([x[b], y[b]], -1), kind)
        assert torch.equal(v[b].T, want)
        assert torch.equal(dx[b].T, g[..., 0])
        assert torch.equal(dy[b].T, g[..., 1])
    assert torch.equal(tinterp.sample_windows(win[:, 0], x, y, kind=kind),
                       v[:, 0])


# Measured on these inputs (CPU, float32 both): val within 4.6e-5
# levels, g (NCC: combined) within 8.9e-7 and JtJ (NCC: the selft
# Hessian) within 2.5e-7 of their norms.
@pytest.mark.parametrize("kind,am,esm,c", [
    ("cubic", "ssd", False, 1), ("cubic", "ncc", True, 1),
    ("cubic", "ssd", False, 3), ("cubic_bspl", "ssd", True, 1)])
def test_plain_k1c_matches_pallas_interpret(monkeypatch, kind, am, esm, c):
    """val within 1.0, g and JtJ (NCC: the combined gradient and selft
    Hessian) within 1e-4 of their norms, in SSD, NCC with ESM's J0 and
    multi-channel SSD (every mode's arithmetic; the card holds all 15
    instantiations against this plain form in `test_torch_gpu.py`)."""
    (win, M0, gens, ph, templ), j0 = all_mode_inputs(100, am, esm, c, b=2,
                                                     size=64)
    jv, jg, jh = pallas_f32(monkeypatch, win, M0, gens, ph, templ, am, j0,
                            kind)
    val, g, h = tk.lk_fused_chain(*_t(win, M0, gens, ph, templ), am=am,
                                  j0=_t(j0)[0], kind=kind)
    np.testing.assert_allclose(val.numpy(), jv, atol=1.0, rtol=0)
    for b in range(2):
        assert_norm_close(g[b].numpy(), jg[b], 1e-4)
        assert_norm_close(h[b].numpy(), jh[b], 1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small CPU runs here take one thread: beside XLA's CPU
    thread pool, PyTorch's spinning OpenMP threads slowed them ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX runs every fleet test compares against, computed once on a
    4-frame synthetic GT leg (rendered by the port, held against the JAX
    package's rendering in `test_torch_fleet.py`): the leg on the generic
    path (its first update is that path's one-update reference), the
    state it starts from, and the first update on the Pallas path."""
    frames, gt = tsynth.synthetic_sequence(
        _scene(), CORNERS, _fleet().sm.ssm, n_frames=4, sigma_scale=0.004,
        seed=3)
    frames = frames.numpy()
    fl = JFleet(jcreate("fclk", "ssd", "8", **FLEET_CFG))
    st = jax_init(fl, frames[0], CORNERS)
    out = {"frames": frames, "gt": gt, "state0": jax.tree.map(np.asarray, st)}
    leg = []
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        leg.append(np.asarray(fl.corners(st)))
    out["generic"] = np.stack(leg)
    pfl = JFleet(jcreate("fclk", "ssd", "8", use_pallas=True, **FLEET_CFG))
    out["pallas"] = np.asarray(pfl.corners(pfl.update(
        jax_init(fl, frames[0], CORNERS), frames[1])))
    return out


def _fleet(donate=False, cfg=FLEET_CFG):
    return TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", **cfg),
                        donate=donate)


@pytest.mark.parametrize("jax_path", ["generic", "pallas"])
def test_one_update_matches_jax(ref, jax_path):
    frames = ref["frames"]
    fl = _fleet()
    got = fl.corners(fl.update(fl.initialize(frames[0], CORNERS),
                               frames[1])).numpy()
    want = ref[jax_path] if jax_path == "pallas" else ref["generic"][0]
    assert np.abs(got - want).max() < CORNER_TOL


def test_gt_leg_matches_jax_per_frame(ref):
    """Each frame of the leg within 0.05 px of the generic JAX path, and
    within 0.2 px of the exact ground truth on average."""
    fl = _fleet(donate=True)
    frames = ref["frames"]
    st = fl.initialize(frames[0], CORNERS)
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - ref["generic"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - ref["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


def test_convert_round_trip_and_update(ref):
    """A JAX-initialised cubic state (the linear layouts), converted and
    updated by the port, gives the JAX update; converting back gives the
    JAX state unchanged."""
    jst = ref["state0"]
    tst = convert.to_torch(jst, device="cpu")
    back = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(
            (jst.ssm_state, jst.am_state, jst.region, jst.extra))):
        np.testing.assert_array_equal(a, b)
    got = _fleet().corners(_fleet().update(tst, ref["frames"][1])).numpy()
    assert np.abs(got - ref["generic"][0]).max() < CORNER_TOL


def test_update_runs_ten_cubic_iterations(ref, monkeypatch):
    """6 + 3 coarse iterations and 1 full-resolution one, each one call
    of the chain kernel wrapper with cubic taps."""
    fl = _fleet(cfg=CUBIC_CFG)
    st = fl.initialize(ref["frames"][0], CORNERS)
    calls = []

    def spy(window, M0, gens, ph, templ, **kw):
        calls.append((ph.shape[-1], kw["kind"]))
        return lk_fused_chain(window, M0, gens, ph, templ, **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    fl.update(st, ref["frames"][1])
    assert calls == [(n, "cubic") for n in [169] * 6 + [625] * 3 + [2500]]


# every fused LK mode the factory accepts, as in the JAX package
FUSED = [("fclk", "ssd"), ("fclk", "ncc"), ("fclk", "mcssd"),
         ("fclm", "ssd"), ("esm", "ssd"), ("esm", "ncc"), ("eslm", "ncc")]


@pytest.mark.parametrize("kind", CUBIC_KINDS)
@pytest.mark.parametrize("key,am", FUSED)
def test_every_fused_mode_runs_with_cubic_taps(key, am, kind):
    """Two updates of one tracker on a small frame (3 channels for
    mcssd), with the instantiation's taps in every kernel call."""
    rng = np.random.default_rng(4)
    c = 3 if am == "mcssd" else 1
    frame = _image01(rng, 96, 120, c)[..., 0 if c == 1 else slice(None)]
    frame = frame * 255.0
    corners = np.array([[[30, 24], [80, 26], [78, 70], [32, 68]]],
                       np.float32)
    sm = tcreate(key, am, "8", device="cpu",
                 **dict(CFG, resx=20, resy=20, crop=64,
                        interp=f"{kind}_mm"))
    assert sm.kind == kind
    st = sm.initialize(frame, corners)
    for shift in ((1, 1), (2, 1)):
        st = sm.update(st, np.roll(frame, shift, (0, 1)))
    c_img = sm.corners(st).numpy().transpose(0, 2, 1)
    assert np.isfinite(c_img).all()
    assert np.abs(c_img - corners - np.float32([1, 2])).max() < 0.5


@pytest.mark.parametrize("key", ["rklt", "grid"])
def test_grid_rejects_cubic_taps(key):
    """The grid, alone or as RKLT's localizer, takes the cubic dense
    kinds (K5c's plain form on each pyramid level): one coarse-to-fine
    patch flow matches the JAX package's XLA joint loop on the same
    patches within 1e-4 template units."""
    frame = _scene()
    got, want = pyr_flow_pair(key, CUBIC_CFG, frame,
                              np.roll(frame, (2, 1), (0, 1)), CORNERS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 1e-3
