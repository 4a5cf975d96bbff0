"""Port parity, slice 5's grid layer: the grid-flow kernel's cubic taps
(K5c, plain form), the gather samplers, the median-flow fit, the Gaussian
pyramid and one grid update in each new configuration (cubic taps, the
gather path on a 3-channel frame, the rigid and f2f flows,
forward-backward masking, Median Flow), each held against the JAX package
on the same inputs (made with numpy); the per-tracker forward-backward
fallback, the state conversions and the build key of the kernels'
shared header.

Grid updates are compared with the JAX package's XLA path within 0.1 px,
its own tolerance between its two grid paths
(`tests/test_r5_features.py:112`), with the JAX package's RANSAC index
draws handed to the port.
"""
import functools
import hashlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu.ops.pallas.grid_flow as jgf
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import interp as jinterp
from mtf_tpu.ops import ransac as jransac
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu.utils import pyramid as jpyramid
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp, ransac
from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels import grid_flow as gf
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.ssm import get_ssm
from mtf_tpu_torch.utils import pyramid
from test_torch_fleet import _scene, side_by_side
from test_torch_gpu import k5_inputs
from test_torch_grid import (GRID_CFG, GRID_CORNERS, GRID_TOL_PX,
                             jax_fit_indices, use_indices)
from test_torch_mc import _F32Jnp, _scene3

CUBIC = ["cubic", "cubic_bspl"]
# a grid update's configuration per case: (SM key, options)
MF_CFG = dict(resx=50, resy=50, interp="linear_mm", crop=160)
UPDATE_CASES = {
    "cubic_mm": ("grid", dict(GRID_CFG, interp="cubic_mm")),
    "linear_3ch": ("grid", dict(GRID_CFG, interp="linear")),
    "rigid": ("grid", dict(GRID_CFG, grid_flow="rigid")),
    "f2f": ("grid", dict(GRID_CFG, grid_flow="f2f")),
    "fb": ("grid", dict(GRID_CFG, grid_fb_err=2.0)),
    "mf": ("mf", MF_CFG),
}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small CPU runs here take one thread: beside XLA's CPU
    thread pool, PyTorch's spinning OpenMP threads slowed them ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- K5c, plain form ----------------------------------------------------------
K5_P, K5_ITERS = 8, 4
# disp, template units, per patch (the acceptance bound); measured on
# these inputs at most ~1e-7 (XLA path) and ~1e-7 (float32 Pallas)
K5C_TOL = 1e-4


def _k5c_ref(win, pts, templ, scale, n, kind):
    return gf.grid_flow_ref(*(_t(a) for a in (win, pts, templ, scale)), n,
                            K5_ITERS, kind=kind).numpy()


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("kind", CUBIC)
def test_plain_k5c_matches_jax_xla_path(kind, n):
    """Against `GridTracker._track_patches_mm` with `kind` taps (the XLA
    joint loop, float32) on each window as the frame, with norm_mat the
    pure scale."""
    win, pts, templ, scale, _ = k5_inputs(n)
    got = _k5c_ref(win, pts, templ, scale, n, kind)
    trk = jcreate("grid", "ssd", "8", interp=f"{kind}_mm", use_pallas=False)
    norm = np.diag([scale[0], scale[0], 1.0]).astype(np.float32)
    fn = jax.jit(lambda w, b, t: trk._track_patches_mm(
        w, jnp.asarray(norm), b, t, K5_ITERS, crop=None))
    for i in range(len(win)):
        base = (pts[i].T / scale[0]).reshape(K5_P, n, 2)
        want = np.asarray(fn(win[i], base, templ[i].reshape(K5_P, n, 1)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=K5C_TOL)
        assert np.abs(want).max() > 1e-3          # the flow moved


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("kind", CUBIC)
def test_plain_k5c_matches_pallas_f32(kind, n, monkeypatch):
    """Against the Pallas kernel in interpret mode with its bf16 casts of
    the window and the tap weights made float32, at a single tile (P·n
    of 128 and 512 points, so no y-band)."""
    win, pts, templ, scale, _ = k5_inputs(n)
    got = _k5c_ref(win, pts, templ, scale, n, kind)
    monkeypatch.setattr(jgf, "jnp", _F32Jnp())
    for i in range(len(win)):
        want = np.asarray(jgf.grid_flow_fused(
            jnp.asarray(win[i]), jnp.asarray(pts[i]), jnp.asarray(templ[i]),
            jnp.float32(scale[i]), n, K5_ITERS, True, kind=kind,
            interpret=True)).T
        np.testing.assert_allclose(got[i], want, rtol=0, atol=K5C_TOL)


def test_grid_flow_kind_dispatch():
    """CPU tensors take the plain form of every kind and count no launch;
    an unknown kind raises on every device."""
    args = [_t(a) for a in k5_inputs(16)[:4]]
    before = dict(gf.grid_flow.launches)
    for kind in gf.KINDS:
        np.testing.assert_array_equal(
            gf.grid_flow(*args, 16, 2, kind=kind).numpy(),
            gf.grid_flow_ref(*args, 16, 2, kind=kind).numpy())
    assert gf.grid_flow.launches == before
    assert len(gf.INSTANTIATIONS) == 18
    with pytest.raises(ValueError, match="unknown tap kind"):
        gf.grid_flow(*args, 16, 2, kind="cubic_mm")
    with pytest.raises(ValueError, match="unknown tap kind"):
        gf.grid_flow(*(a.to("meta") for a in args), 16, 2, kind="nearest")


# -- samplers, median flow, pyramid -------------------------------------------
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", ["linear", "cubic", "cubic_bspl"])
def test_sample_val_grad_matches_jax(kind, c):
    """Values and gradients by gather within 1e-4 of 0-255 levels of
    `_sample_val_grad`, integer and out-of-image points included (the
    linear derivative is one-sided there, not 0), for a batch of point
    sets."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (30, 40, c)).astype(np.float32)
    img = img[..., 0] if c == 1 else img
    pts = rng.uniform(-3, 43, (2, 150, 2)).astype(np.float32)
    pts[:, :30] = np.round(pts[:, :30])
    val, grad = interp.sample_val_grad(_t(img), _t(pts), kind)
    fn = jax.jit(jax.vmap(lambda p: jinterp._sample_val_grad(
        jnp.asarray(img), p, kind, "replicate", 0.0, True)))
    jv, jg = fn(pts)
    np.testing.assert_allclose(val.numpy(), np.asarray(jv), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(interp.sample_grad(_t(img), _t(pts),
                                                     kind).numpy(),
                                  grad.numpy())


@functools.cache
def _jax_median_flow_fit():
    """The JAX package's median flow fit, per tracker; one compile
    serves every case (their shapes are the same)."""
    jssm = jget_ssm("8")
    return jax.jit(jax.vmap(
        lambda s, d, w: jransac.median_flow_fit(jssm, s, d, w)))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("n_valid", [100, 99], ids=["even", "odd"])
def test_median_flow_fit_matches_jax(n_valid, weighted):
    """The state and weights within 1e-5 of the JAX package's, on an even
    and an odd count of valid points (an even count of pair ratios either
    way: the median is the mean of the middle two, as `jnp.nanmedian`,
    not `torch.nanmedian`'s lower one); weights of 0 drop points, and a
    tracker with one valid point keeps scale 1."""
    rng = np.random.default_rng(7)
    src = rng.uniform(-0.5, 0.5, (3, 100, 2)).astype(np.float32)
    dst = (1.07 * src + [0.03, -0.02]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = np.ones((3, 100), np.float32)
    w[:, n_valid:] = 0.0
    if weighted:
        w[0, :20] = 0.0
        w[2, :] = 0.0
        w[2, 5] = 1.0
    ssm = get_ssm("8", device="cpu")
    got, got_w = ransac.robust_fit(ssm, _t(src), _t(dst), None,
                                   method="median", weights=_t(w))
    want, want_w = _jax_median_flow_fit()(src, dst, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("shape", [(31, 40), (32, 41), (31, 40, 3),
                                   (32, 41, 3)])
def test_gaussian_downsample_matches_jax(shape):
    """ceil(H/2) x ceil(W/2), within 1e-4 levels, 2-D and 3-channel; and
    a 3-level pyramid."""
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    got = pyramid.build_pyramid(_t(img), 3)
    want = jpyramid.build_pyramid(jnp.asarray(img), 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


# -- grid updates --------------------------------------------------------
def pyr_flow_pair(key, cfg, frame, f2, corners):
    """One coarse-to-fine patch flow of the port's grid (`key` "grid", or
    RKLT's localizer for "rklt") and of the JAX package's grid (XLA path)
    from the same init state at the identity warp, on frame f2 ->
    (port disp (B, P, 2), JAX disp (B, P, 2)), template units."""
    sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
    g = sm.grid_sm if key == "rklt" else sm
    st = g.initialize(frame, corners)
    gs = st.extra
    pts = gs.centers0[:, :, None] + gs.offsets[:, None]
    got = g._track_patches_pyr(g._pyr_frames(_t(f2)), st.region.norm_mat,
                               pts, gs.templates)
    return got.numpy(), _jax_pyr_flow(cfg, frame, f2, corners)


_JAX_PYR_FLOW = {}


def _jax_pyr_flow(cfg, frame, f2, corners):
    """`pyr_flow_pair`'s JAX side; the same grid options on the same
    inputs (the grid alone and as RKLT's localizer) compile and run once."""
    arrays = [np.ascontiguousarray(a) for a in (frame, f2, corners)]
    key = (repr(sorted(cfg.items())),) + tuple(
        (a.shape, hashlib.sha256(a.tobytes()).hexdigest()) for a in arrays)
    if key not in _JAX_PYR_FLOW:
        jg = jcreate("grid", "ssd", "8", use_pallas=False, **cfg)

        def one(c):
            s = jg.initialize(jnp.asarray(frame), c)
            e = s.extra
            return jg._track_patches_pyr(
                jnp.asarray(f2), s.region.norm_mat,
                e.centers0[:, None] + e.offsets[None], e.templates,
                jg.grid.sub_iters)

        _JAX_PYR_FLOW[key] = np.asarray(jax.jit(jax.vmap(one))(corners))
    return _JAX_PYR_FLOW[key]


def _frames(case):
    frame = _scene3(0) if case == "linear_3ch" else _scene(0)
    return frame, np.roll(frame, (3, 2), (0, 1))


@pytest.fixture(scope="module")
def update_ref():
    """One JAX grid update (XLA path) per case, every case's compile side
    by side on first use: (corners, fit weights, the initial state as
    numpy arrays)."""
    cache = {}

    def fill(case):
        key, cfg = UPDATE_CASES[case]
        frame, f2 = _frames(case)
        fl = JFleet(jcreate(key, "ssd", "8", use_pallas=False, **cfg))
        st0 = fl.initialize(frame, GRID_CORNERS)
        st = fl.update(st0, f2)
        cache[case] = (np.asarray(fl.corners(st)),
                       np.asarray(st.extra.inlier_mask),
                       jax.tree.map(np.asarray, st0))

    def get(case):
        if not cache:
            side_by_side([functools.partial(fill, c) for c in UPDATE_CASES])
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_grid_update_matches_jax(update_ref, case):
    """Corners within 0.1 px of the JAX XLA path and the same fit weights
    (the forward-backward mask for fb and mf)."""
    key, cfg = UPDATE_CASES[case]
    frame, f2 = _frames(case)
    sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
    use_indices(sm, jax_fit_indices(1))
    fl = TrackerFleet(sm)
    st = fl.update(fl.initialize(frame, GRID_CORNERS), f2)
    corners, inl, _ = update_ref(case)
    assert np.abs(fl.corners(st).numpy() - corners).max() < GRID_TOL_PX
    np.testing.assert_array_equal(st.extra.inlier_mask.numpy(), inl)
    assert (st.extra.prev_frame is not None) == (case in ("f2f", "fb", "mf"))
    if case == "linear_3ch":
        assert st.extra.templates.shape == (2, 2, 100, 64, 3)


def test_mf_factory_settings():
    """mf / mflow / medianflow: f2f, fb 2.0 px, 20 iterations on 3
    levels, the median similarity, as the JAX package's keys."""
    for key in ("mf", "mflow", "medianflow"):
        t = tcreate(key, "ssd", "8", device="cpu", **MF_CFG).grid
        j = jcreate(key, "ssd", "8", **MF_CFG).grid
        for f in ("flow", "fb_err_px", "sub_iters", "pyramid_levels",
                  "estimator"):
            assert getattr(t, f) == getattr(j, f), f
    assert (t.flow, t.fb_err_px, t.sub_iters, t.pyramid_levels,
            t.estimator) == ("f2f", 2.0, 20, 3, "median")


def test_fb_fallback_is_per_tracker(monkeypatch):
    """The forward-backward mask per tracker: tracker 0 loses the patches
    whose round trip misses by 2 px or more; tracker 1 loses every patch,
    fewer than the minimal sample, so it falls back to all of them; no
    tracker's mask moves another's."""
    sm = tcreate("grid", "ssd", "8", device="cpu",
                 **dict(GRID_CFG, grid_fb_err=2.0))
    frame, f2 = _frames("fb")
    st = sm.initialize(frame, GRID_CORNERS)
    scale = st.region.norm_mat[:, 0, 0]
    calls = []

    def pyr(frames, norm_mat, pts_base, templates):
        calls.append(len(calls))
        d = torch.zeros(pts_base.shape[:2] + (2,))
        if len(calls) == 2:                           # the way back
            d[0, :30, 0] = 3.0 / scale[0]             # 3 px round trip
            d[1, :, 1] = 5.0 / scale[1]               # every patch fails
        return d

    seen = {}

    def fit(region, centers0, centers_new, step, weights=None):
        seen["w"] = weights
        return st.ssm_state, torch.ones(centers0.shape[:2])

    monkeypatch.setattr(sm, "_track_patches_pyr", pyr)
    monkeypatch.setattr(sm, "_fit_warp", fit)
    sm.update(st, f2)
    w = seen["w"].numpy()
    assert len(calls) == 2
    np.testing.assert_array_equal(w[0, :30], 0.0)
    np.testing.assert_array_equal(w[0, 30:], 1.0)
    np.testing.assert_array_equal(w[1], 1.0)


# -- conversions ---------------------------------------------------------
def test_convert_grid_state_with_previous_frame(update_ref):
    """A JAX Median Flow fleet's state (B copies of the previous frame)
    -> one shared frame in the port -> the JAX layout again (B copies as
    a view); updating the converted state matches the port's own; with
    `donate` the shared frame is copied into the state, not aliased."""
    frame, f2 = _frames("mf")
    js = update_ref("mf")[2]
    assert js.extra.prev_frame.shape == (2,) + frame.shape
    sm = tcreate("mf", "ssd", "8", device="cpu", **MF_CFG)
    st = convert.to_torch(js, "cpu", sm)
    assert st.extra.prev_frame.shape == frame.shape
    back = convert.to_numpy(st)
    for f in ("templates", "offsets", "centers0", "inlier_mask",
              "prev_frame"):
        np.testing.assert_array_equal(getattr(back.extra, f),
                                      getattr(js.extra, f))
    own = sm.initialize(frame, GRID_CORNERS)
    fl = TrackerFleet(sm, donate=True)
    f2_t = torch.tensor(f2)
    out = fl.update(st, f2_t)
    assert out is st and torch.equal(st.extra.prev_frame, f2_t)
    assert st.extra.prev_frame.data_ptr() != f2_t.data_ptr()
    np.testing.assert_allclose(sm.corners(out).numpy(),
                               sm.corners(sm.update(own, f2)).numpy(),
                               atol=1e-4, rtol=0)
    bad = js._replace(extra=js.extra._replace(
        prev_frame=np.stack([frame, f2])))
    with pytest.raises(ValueError, match="previous frames differ"):
        convert.to_torch(bad, "cpu", sm)


# -- the kernels' build key ----------------------------------------------
def test_build_key_covers_the_shared_header(tmp_path):
    """Both kernel sources include `dense_taps.cuh`; an edit to the header
    changes both build keys (a stale library is never reused), an edit
    to one source only that source's."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("grid_flow", "lk_fused_chain")
    for name in names:
        assert [p.name for p in _build._sources(csrc / f"{name}.cu")] == [
            f"{name}.cu", "dense_taps.cuh"]
    before = {n: _build.digest(n, csrc) for n in names}
    assert before == {n: _build.digest(n) for n in names}
    hdr = csrc / "dense_taps.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build.digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "grid_flow.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.digest("grid_flow", csrc) != after["grid_flow"]
    assert _build.digest("lk_fused_chain", csrc) == after["lk_fused_chain"]
