"""Port parity, slice 4 (multi-channel): the `mcssd` fleet (FCLK + SSD
over 3 channels + 8-DOF homography) on the chain kernel's multi-channel
mode (K4), stepped by `mtf_tpu_torch` and by the JAX package on the same
3-channel frames. Corners must agree within 0.05 px, the chain kernel's
parity tolerance in the JAX package's own tests
(`tests/test_r5_features.py:53-72`), on both JAX paths (generic XLA, and
the Pallas chain kernel in interpret mode). Its LM variant `fclm` runs
the same kernel calls, and its objective samples every channel.

The plain K4 is held against the JAX Pallas kernel in interpret mode
with its bf16 casts made float32 (the same algorithm in float32: the
TPU's bf16 window and tap weights are a layout choice the port does not
copy), at small N and window sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu.ops.pallas.lk_fused as jlk
import mtf_tpu_torch.sm.lk as lk_mod
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm.lk import LKBase
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp as tinterp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm.lk import _blur2
from mtf_tpu_torch.utils import synth as tsynth
from test_torch_fleet import (CFG, CORNER_TOL, CORNERS, builds_like_jax,
                              jax_init)
from test_torch_gpu import assert_norm_close, mc_inputs

# off the integer grid, so no base point sits exactly on an integer
# coordinate in one package and not the other (where the dense linear
# derivative steps; ROADMAP Queue 3)
MC_CORNERS = CORNERS + np.float32(0.37)
# the fleet parity runs' schedule: one coarse phase at stride 2 (its
# multi-channel pack included) and 2 full-resolution iterations; the JAX
# compile time grows with the phases, and the benchmark's 6 + 3 + 1 runs
# in `test_update_runs_ten_mc_iterations` and on the card
FLEET_CFG = dict(CFG, max_iters=6, coarse_pt_iters=((2, 4),))


def _scene3(seed=1, h=240, w=320):
    """3-channel smooth scene with correlated channels (shared structure
    plus per-channel detail, `bench_extra.py:_scene3`), at the CPU tests'
    size."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    img = np.stack([base + np.cumsum(np.cumsum(
        rng.normal(0, 0.4, (h, w)), 0), 1) for _ in range(3)], -1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


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
    4-frame synthetic GT leg of 3-channel frames (rendered by the port;
    `test_synthetic_multichannel_frames_match` holds the rendering
    against the JAX package's): the leg on the generic path (its first
    update is the one-update reference of that path), the state it starts
    from, and the first update on the Pallas path."""
    frames, gt = tsynth.synthetic_sequence(
        _scene3(), MC_CORNERS, _fleet().sm.ssm, n_frames=4,
        sigma_scale=0.004, seed=3)
    frames = frames.numpy()
    fl = JFleet(jcreate("fclk", "mcssd", "8", **FLEET_CFG))
    st = jax_init(fl, frames[0], MC_CORNERS)
    out = {"frames": frames, "gt": gt, "state0": jax.tree.map(np.asarray, st)}
    leg = []
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        leg.append(np.asarray(fl.corners(st)))
    out["generic"] = np.stack(leg)
    pfl = JFleet(jcreate("fclk", "mcssd", "8", use_pallas=True,
                         **FLEET_CFG))
    out["pallas"] = np.asarray(pfl.corners(pfl.update(
        jax_init(fl, frames[0], MC_CORNERS), frames[1])))
    return out


def _fleet(key="fclk", am="mcssd", donate=False, cfg=FLEET_CFG):
    return TrackerFleet(tcreate(key, am, "8", device="cpu", **cfg),
                        donate=donate)


@pytest.mark.parametrize("jax_path", ["generic", "pallas"])
def test_one_update_matches_jax(ref, jax_path):
    frames = ref["frames"]
    fl = _fleet()
    got = fl.corners(fl.update(fl.initialize(frames[0], MC_CORNERS),
                               frames[1])).numpy()
    want = ref[jax_path] if jax_path == "pallas" else ref["generic"][0]
    assert np.abs(got - want).max() < CORNER_TOL


def test_gt_leg_matches_jax_per_frame(ref):
    """Each frame of the leg within 0.05 px of the generic JAX path, and
    within 0.2 px of the exact ground truth on average."""
    fl = _fleet(donate=True)
    frames = ref["frames"]
    st = fl.initialize(frames[0], MC_CORNERS)
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - ref["generic"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - ref["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


# The packages round the template grid's coordinates (and the rendered
# frames' sampling coordinates) differently by ~1e-4 px (3x3 inverse,
# matmul order; see `test_torch_fleet._scene`); times this scene's
# gradients that is the values' disagreement: measured at most 1.1e-3
# levels, on 3 of the 22,500 template values (and 1.4e-3 on 45 of the
# 921,600 values of the leg's frames rendered by each package).
RENDER_ATOL = 2e-3


def test_synthetic_multichannel_frames_match():
    """`synthetic_sequence` renders (H, W, 3) frames as the JAX package
    does (cubic warps of every channel), with noise and drift."""
    img = _scene3(2, 48, 64)
    corners = np.array([[20, 12], [44, 12], [44, 36], [20, 36]], np.float32)
    kw = dict(n_frames=3, sigma_scale=0.01, seed=5, noise_sigma=2.0,
              gain_drift=0.05, bias_drift=1.5)
    jf, jgt = jsynth.synthetic_sequence(img, corners,
                                        jcreate("fclk", "ssd", "8").ssm, **kw)
    tf, tgt = tsynth.synthetic_sequence(img, corners, _fleet().sm.ssm, **kw)
    assert tuple(tf.shape) == (3, 48, 64, 3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=RENDER_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tgt, jgt, atol=1e-3, rtol=0)


# J0 and the coarse packs' Jacobians are sums of products of sampled
# gradients and the warp Jacobian; the two packages round them in another
# order (measured: within 1.3e-6 of each tracker's norm on this scene; a
# channel-major J0 misses by 3.6e-2).
J0_REL = 1e-5


def test_init_state_matches_jax_layouts(ref):
    """The port's own init state has the JAX package's MC layouts: the
    template (N, 3), J0 (N·3, S) with rows interleaved n·3 + c, and each
    coarse pack (templ (n, 3), H0 (S, S), J (n·3, S)), with a batch axis
    in front; the values agree (a transposed J0 would agree only on one
    channel)."""
    jst = ref["state0"]
    st = _fleet().sm.initialize(ref["frames"][0], MC_CORNERS)
    np.testing.assert_allclose(st.am_state.template.numpy(),
                               jst.am_state.template, atol=RENDER_ATOL,
                               rtol=0)
    packs = [(st.extra.J0, jst.extra.J0, st.extra.H0, jst.extra.H0)]
    packs += [(p[2], jp[2], p[1], jp[1])
              for p, jp in zip(st.extra.coarse, jst.extra.coarse)]
    for p, jp in zip(st.extra.coarse, jst.extra.coarse):
        assert p[0].shape == jp[0].shape and p[0].shape[-1] == 3
        np.testing.assert_allclose(p[0].numpy(), jp[0], atol=RENDER_ATOL,
                                   rtol=0)
    for J, jJ, H, jH in packs:
        assert J.shape == jJ.shape
        for b in range(len(MC_CORNERS)):
            assert_norm_close(J[b].numpy(), jJ[b], J0_REL)
            assert_norm_close(H[b].numpy(), jH[b], J0_REL)


def test_convert_round_trip_and_update(ref):
    """A JAX-initialised MC state, converted and updated by the port,
    gives the JAX update; converting back gives the JAX state
    unchanged."""
    jst = ref["state0"]
    tst = convert.to_torch(jst, device="cpu")
    assert tst.am_state.template.shape == (len(MC_CORNERS), 2500, 3)
    assert tst.extra.J0.shape == (len(MC_CORNERS), 7500, 8)
    back = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(
            (jst.ssm_state, jst.am_state, jst.region, jst.extra))):
        np.testing.assert_array_equal(a, b)
    got = _fleet().corners(_fleet().update(tst, ref["frames"][1])).numpy()
    assert np.abs(got - ref["generic"][0]).max() < CORNER_TOL


def test_update_runs_ten_mc_iterations(ref, monkeypatch):
    """6 + 3 coarse iterations and 1 full-resolution one, each one call
    of the chain kernel wrapper on channel-stacked (B, 3, 144, 144)
    windows and (B, 3, n) templates (LM adds no kernel call)."""
    for key in ("fclk", "fclm"):
        fl = _fleet(key, cfg=CFG)
        st = fl.initialize(ref["frames"][0], MC_CORNERS)
        calls = []

        def spy(window, M0, gens, ph, templ, **kw):
            calls.append((tuple(window.shape), tuple(templ.shape)))
            return lk_fused_chain(window, M0, gens, ph, templ, **kw)

        monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
        fl.update(st, ref["frames"][1])
        b = len(MC_CORNERS)
        assert calls == [((b, 3, 144, 144), (b, 3, n))
                         for n in [169] * 6 + [625] * 3 + [2500]], key


def test_lm_objective_samples_every_channel():
    """The LM objective of fclm (`_f` through `sample_windows`) samples
    each channel of the (B, C, Hc, Wc) window as the dense sampler
    samples the (Hc, Wc, C) window (held against the JAX package in
    `test_torch_cubic.py`), and moves when any one channel changes."""
    sm = tcreate("fclm", "mcssd", "8", device="cpu", **CFG)
    assert sm.prm.enable_lm
    rng = np.random.default_rng(3)
    win = torch.tensor(rng.uniform(0, 255, (2, 3, 20, 24)),
                       dtype=torch.float32)
    x = torch.tensor(rng.uniform(-2, 26, (2, 30)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(-2, 22, (2, 30)), dtype=torch.float32)
    val = tinterp.sample_windows(win, x, y)                  # (2, 3, 30)
    for b in range(2):
        want, _ = tinterp.sample_dense(win[b].permute(1, 2, 0),
                                       torch.stack([x[b], y[b]], -1),
                                       need_grad=False)
        assert torch.equal(val[b].T, want)
    st = sm.am.init(val.transpose(1, 2))
    win2 = win.clone()
    win2[:, 2] += 5.0
    f2 = sm.am.f_corrected(st, tinterp.sample_windows(win2, x, y)
                           .transpose(1, 2))
    assert bool((f2 < -1.0).all())


@pytest.mark.parametrize("stride", [2, 4])
def test_blur2_multichannel_matches_jax(stride):
    rng = np.random.default_rng(stride)
    img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    got = _blur2(torch.tensor(img), stride)
    want = np.asarray(LKBase._blur2(jnp.asarray(img), stride))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    for c in range(3):
        np.testing.assert_allclose(
            got[..., c].numpy(), _blur2(torch.tensor(img[..., c]),
                                        stride).numpy(), atol=1e-4, rtol=0)


class _F32Jnp:
    """`jax.numpy` with bfloat16 read as float32: handed to the Pallas
    kernel's module, it makes the kernel's window and tap-weight casts
    no-ops."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def pallas_f32(monkeypatch, win, M0, gens, ph, templ, am="ssd", j0=None,
               kind="linear"):
    """The JAX wrapper and Pallas kernel in interpret mode, in float32,
    batched over trackers; a (B, C, Hc, Wc) window goes in
    channel-stacked (C·Hc, Wc) with `channels=C`."""
    monkeypatch.setattr(jlk, "jnp", _F32Jnp())
    ch = win.shape[1] if win.ndim == 4 else 1
    gj = jnp.asarray(gens)

    def one(w, m, p, t, *j):
        if ch > 1:
            w = w.reshape(ch * w.shape[1], w.shape[2])
        return jlk.lk_fused_chain(w, m, gj, p, t, kind, interpret=True,
                                  am=am, j0=j[0] if j else None,
                                  channels=ch)

    args = [jnp.asarray(a) for a in (win, M0, ph, templ)]
    args += [] if j0 is None else [jnp.asarray(j0)]
    out = jax.jit(jax.vmap(one))(*args)
    monkeypatch.undo()
    return [np.asarray(a) for a in out]


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


# Measured on these inputs (CPU, float32 both): val within 6.1e-5
# levels, g within 2.7e-7 and JtJ within 2.4e-7 of their norms.
@pytest.mark.parametrize("c,n", [(2, 100), (4, 400)])
def test_plain_k4_matches_pallas_interpret(monkeypatch, c, n):
    """val (B, C, N) within 1.0, g and JtJ within 1e-4 of their norms
    (`tests/test_dense_interp.py:176-181`)."""
    args = mc_inputs(n, c, b=2, size=64)
    jv, jg, jh = pallas_f32(monkeypatch, *args)
    val, g, h = tk.lk_fused_chain(*_t(*args))
    assert val.shape == (2, c, n)
    np.testing.assert_allclose(val.numpy(), jv, atol=1.0, rtol=0)
    for b in range(2):
        assert_norm_close(g[b].numpy(), jg[b], 1e-4)
        assert_norm_close(h[b].numpy(), jh[b], 1e-4)


def test_kernel_modes_outside_the_trackers_raise():
    """Only what the trackers reach is instantiated: multi-channel SSD
    without ESM. NCC or ESM on a channel-stacked window raises on every
    device, as does an unknown tap kind."""
    win, M0, gens, ph, templ = _t(*mc_inputs(100, 3, b=2, size=64))
    j0 = torch.zeros(2, 8, 100)
    with pytest.raises(ValueError, match="ssd_mc|ncc_mc"):
        tk.lk_fused_chain(win, M0, gens, ph, templ, am="ncc")
    with pytest.raises(ValueError, match="ssd_esm_mc"):
        tk.lk_fused_chain(win, M0, gens, ph, templ, j0=j0)
    with pytest.raises(ValueError, match="kind"):
        tk.lk_fused_chain(win, M0, gens, ph, templ, kind="nearest")
    assert "ssd_mc" in tk.lk_fused_chain_raw.launches
    # the 15 instantiations at each state size, with plain and blurred
    # taps, and with plain taps under the bfloat16-operand flag
    assert len(tk.INSTANTIATIONS) == 15
    assert len(tk.lk_fused_chain_raw.launches) == 15 * 3 * len(tk.STATE_DIMS)
    assert "ssd_mc+bf16" in tk.lk_fused_chain_raw.launches


@pytest.mark.parametrize("key", ["mcssd", "ssd3", "MCSSD"])
def test_factory_mc_keys(key):
    """The JAX keys for 3-channel SSD build the same tracker class with
    3 channels, and run (H, W, 3) frames."""
    t = tcreate("fclk", key, "8", device="cpu", **CFG)
    j = jcreate("fclk", key, "8", **CFG)
    assert type(t).__name__ == type(j).__name__
    assert t.am.name == j.am.name == "ssd"
    assert t.am.prm.n_channels == j.am.prm.n_channels == 3


@pytest.mark.parametrize("args", [
    ("esm", "mcssd", "8"),          # ESM + MC: the generic AD path
    ("eslm", "ssd3", "8"),
    ("fclk", "mcncc", "8"),         # NCC + MC: the generic AD path
    ("rklt", "mcssd", "8"),         # its refiner is ESM
])
def test_factory_rejects_mc_outside_the_fused_path(args):
    """Multi-channel configurations off the chain kernel (ESM or NCC on
    (H, W, 3) frames, rklt's ESM refiner) build as the JAX package builds
    them and take its generic path (`test_torch_fleet.builds_like_jax`)."""
    builds_like_jax(args, CFG, channels=3)


def test_frames_outside_the_fused_path_raise():
    """Five channels, or ESM on a multi-channel frame, take the generic
    path, as the JAX package's `_fused_ok` sends them there: a 5-channel
    SSD update within 0.05 px of the JAX package's (16x16 templates, 3
    iterations), and ESM on 3 channels with no chain-kernel call; a gray
    frame still runs on an mcssd tracker, and an (H, W, 1) frame is a gray
    frame; the grid runs on (H, W, C) frames, its patch flow as the JAX
    package's."""
    rng = np.random.default_rng(0)
    frame = np.stack([np.roll(_scene3(0)[..., k % 3], k, 1)
                      for k in range(5)], -1)[:120, :160]
    corners = CORNERS[:2] * 0.5 + np.float32([0.31, 0.27])
    f2 = np.roll(frame, (1, 1), (0, 1))
    small = dict(CFG, resx=16, resy=16, max_iters=3)
    jfl = JFleet(jcreate("fclk", "mcssd", "8", **small))
    want = np.asarray(jfl.corners(jfl.update(jax_init(jfl, frame, corners),
                                             f2)))
    fl5 = TrackerFleet(tcreate("fclk", "mcssd", "8", device="cpu", **small))
    got = fl5.corners(fl5.update(fl5.initialize(frame, corners), f2))
    assert np.abs(got.numpy() - want).max() < CORNER_TOL
    esm = TrackerFleet(tcreate("esm", "ssd", "8", device="cpu", **small))
    st = esm.update(esm.initialize(frame[..., :3], corners), f2[..., :3])
    assert torch.isfinite(esm.corners(st)).all()
    assert not esm.sm._fused_ok(st, torch.tensor(frame[..., :3]))
    frame = rng.uniform(0, 255, (120, 160, 5)).astype(np.float32)
    corners = CORNERS[:1] * 0.5
    fl = _fleet()
    one = fl.update(fl.initialize(frame[..., :1], corners), frame[..., :1])
    gray = fl.update(fl.initialize(frame[..., 0], corners), frame[..., 0])
    assert torch.equal(one.ssm_state, gray.ssm_state)
    # the grid samples (H, W, C) patches by gather (dense kinds on the
    # whole frame), as the JAX package's per-patch path
    from test_torch_grid_family import pyr_flow_pair
    f3 = _scene3(0)
    got, want = pyr_flow_pair("grid", CFG, f3, np.roll(f3, (2, 1), (0, 1)),
                              CORNERS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
