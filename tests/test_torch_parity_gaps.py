"""Port parity, the last gaps: the sub-tracker grid without a crop, the
JAX package's public helpers the port had lacked, and faults 19-20 of
ROADMAP Queue 3 (the exception type of a bad key, the frame bridge's
reader).

Each helper is held against its JAX function on the same seeded numpy
inputs: exactly for the corner helpers and the registries, within
float32 rounding for the samplers (1e-5 of the values' scale; the
finite-difference gradient 1e-4, its differences of samples divided by
a half-pixel step), and within 1e-4 of the norm for `dwdp_at` and
`sample_hess_fd`. The no-crop grids match the JAX `SubTrackerGrid` within
0.1 px after one grid update (the grid-kernel tolerance, ROADMAP),
handed the JAX RANSAC draws, with corners off the pixel grid (ROADMAP
Queue 3, item 2); their JAX references compile side by side first.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu_torch
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import interp as jinterp
from mtf_tpu.ops import linalg as jlinalg
from mtf_tpu.ops import spi as jspi
from mtf_tpu.ops import warp as jwarp
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm import core as jcore
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp, linalg, spi, warp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm import SearchMethod, SMParams, TrackerState, core
from mtf_tpu_torch.sm import lk as lk_mod
from mtf_tpu_torch.sm.grid import SubTrackerGrid
from mtf_tpu_torch.utils import synth
from mtf_tpu_torch.utils.excp import InvalidArgument
from test_torch_fleet import jax_init, side_by_side
from test_torch_grid import jax_fit_indices, use_indices

SAMPLER_REL = 1e-5       # float32 rounding of a sample, of the values' scale
FD_REL = 1e-4            # a difference of samples over a half-pixel step
NORM_REL = 1e-4          # dwdp_at, sample_hess_fd: of the norm
GRID_TOL_PX = 0.1        # one grid update (the grid kernel's tolerance)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU runs beside XLA's thread pool: one PyTorch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(
        np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# -- ops/warp, ops/spi, ops/linalg, utils/synth -----------------------------
def test_corner_helpers_match_jax_exactly():
    rng = np.random.default_rng(1)
    c24 = rng.uniform(0, 100, (5, 2, 4)).astype(np.float32)
    c42 = rng.uniform(0, 100, (5, 4, 2)).astype(np.float32)
    for b in range(5):
        np.testing.assert_array_equal(
            warp.corners_mtf_to_pts(_t(c24))[b],
            jwarp.corners_mtf_to_pts(jnp.asarray(c24[b])))
        np.testing.assert_array_equal(
            warp.pts_to_corners_mtf(_t(c42))[b],
            jwarp.pts_to_corners_mtf(jnp.asarray(c42[b])))
        np.testing.assert_array_equal(
            warp.center_of_corners(_t(c42))[b],
            jwarp.center_of_corners(jnp.asarray(c42[b])))


def test_spi_registry_matches_jax():
    """The same keys; each mask against its JAX function."""
    assert sorted(spi.SPI_REGISTRY) == sorted(jspi.SPI_REGISTRY)
    rng = np.random.default_rng(2)
    ry = rx = 8
    patch = rng.uniform(0, 255, (2, ry * rx, 1)).astype(np.float32)
    templ = patch + rng.normal(0, 20, patch.shape).astype(np.float32)
    for key, fn in spi.SPI_REGISTRY.items():
        jfn = jspi.SPI_REGISTRY[key]
        got = (fn(_t(templ), _t(patch), 0.2) if key == "pix_diff"
               else fn(_t(patch), ry, rx, 0.2)).numpy()
        for b in range(2):
            want = (jfn(templ[b], patch[b], 0.2) if key == "pix_diff"
                    else jfn(patch[b], ry, rx, 0.2))
            _close(got[b], want, SAMPLER_REL, key)


def test_chol_solve_small_jitter_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (4, 6, 6)).astype(np.float32)
    A = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(6, dtype=np.float32)
    b = rng.normal(0, 1, (4, 6)).astype(np.float32)
    for jitter in (0.0, 0.5):
        got = linalg.chol_solve_small(_t(A), _t(b), jitter=jitter).numpy()
        want = jax.vmap(lambda m, v: jlinalg.chol_solve_small(
            m, v, jitter=jitter))(jnp.asarray(A), jnp.asarray(b))
        _close(got, want, NORM_REL, f"jitter {jitter}")
    assert not np.allclose(linalg.chol_solve_small(_t(A), _t(b)).numpy(),
                           linalg.chol_solve_small(_t(A), _t(b), 0.5).numpy())


def test_mean_corner_distance_matches_jax():
    rng = np.random.default_rng(4)
    c1 = rng.uniform(0, 100, (3, 4, 2)).astype(np.float32)
    c2 = c1 + rng.normal(0, 1, c1.shape).astype(np.float32)
    want = jsynth.mean_corner_distance(c1, c2)
    assert synth.mean_corner_distance(c1, c2) == want
    assert synth.mean_corner_distance(_t(c1), _t(c2)) == want


# -- ops/interp --------------------------------------------------------------
def test_interp_constants_match_jax():
    for name in ("NEAREST", "LINEAR", "CUBIC", "CUBIC_BSPL", "LINEAR_MM",
                 "CUBIC_MM", "CUBIC_BSPL_MM", "REPLICATE", "CONSTANT"):
        assert getattr(interp, name) == getattr(jinterp, name), name


def _sample_inputs(seed=5):
    """A gray and a 2-channel image, and points of which a quarter lie
    outside the image (the constant border reads cval there)."""
    rng = np.random.default_rng(seed)
    img = _scene(24, 32, seed)
    img2 = np.stack([img, img[::-1].copy()], -1)
    pts = np.concatenate([rng.uniform(1, 30, (30, 2)),
                          rng.uniform(-4, 36, (10, 2))]).astype(np.float32)
    pts[:, 1] *= 22 / 30
    return img, img2, pts


@pytest.mark.parametrize("kind", ["nearest", "linear", "cubic",
                                  "cubic_bspl"])
@pytest.mark.parametrize("border,cval", [("replicate", 0.0),
                                         ("constant", 0.0),
                                         ("constant", 37.5)])
def test_samplers_match_jax(kind, border, cval):
    """`sample`, `sample_with_grad`, `sample_grad`, `sample_grad_fd` and
    `sample_hess_fd` with `cval`, on a gray and a 2-channel image, over a
    batch of 2 point sets."""
    img, img2, pts = _sample_inputs()
    for im in (img, img2):
        tp = torch.stack([_t(pts), _t(pts[::-1].copy())])
        kw = dict(kind=kind, border=border, cval=cval)
        got = {"sample": interp.sample(_t(im), tp, **kw),
               "with_grad": interp.sample_with_grad(_t(im), tp, **kw),
               "grad": interp.sample_grad(_t(im), tp, **kw),
               "grad_fd": interp.sample_grad_fd(_t(im), tp, 0.5, **kw),
               "hess_fd": interp.sample_hess_fd(_t(im), tp, 0.5, **kw)}
        for b, p in enumerate((pts, pts[::-1].copy())):
            ji, jp = jnp.asarray(im), jnp.asarray(p)
            want = {"sample": jinterp.sample(ji, jp, kind, border, cval),
                    "with_grad": jinterp.sample_with_grad(ji, jp, **kw),
                    "grad": jinterp.sample_grad(ji, jp, **kw),
                    "grad_fd": jinterp.sample_grad_fd(ji, jp, 0.5, **kw),
                    "hess_fd": jinterp.sample_hess_fd(ji, jp, 0.5, **kw)}
            _close(got["sample"][b], want["sample"], SAMPLER_REL, "sample")
            for i in range(2):
                _close(got["with_grad"][i][b], want["with_grad"][i],
                       SAMPLER_REL, ("with_grad", i))
            _close(got["grad"][b], want["grad"], SAMPLER_REL, "grad")
            _close(got["grad_fd"][b], want["grad_fd"], FD_REL, "grad_fd")
            g, w = got["hess_fd"][b].numpy(), np.asarray(want["hess_fd"])
            assert (np.linalg.norm(g - w)
                    <= NORM_REL * np.linalg.norm(w)), "hess_fd"


def test_cval_reaches_only_taps_outside_the_image():
    img, _, pts = _sample_inputs()
    a = interp.sample(_t(img), _t(pts), "linear", "constant", 0.0)
    b = interp.sample(_t(img), _t(pts), "linear", "constant", 100.0)
    inside = ((pts >= 0) & (pts <= [30, 22])).all(-1)
    assert torch.equal(a[inside], b[inside])
    assert (b[~inside] > a[~inside]).all()
    # the dense kinds ignore cval, as in the JAX package
    assert torch.equal(interp.sample(_t(img), _t(pts), "linear_mm",
                                     "constant", 100.0),
                       interp.sample(_t(img), _t(pts), "linear_mm"))


@pytest.mark.parametrize("kind", ["linear", "cubic", "cubic_bspl"])
def test_sample_dense_parts_matches_jax(kind):
    img, img2, pts = _sample_inputs(6)
    for im in (img, img2):
        for crop in (None, 16):
            got = interp.sample_dense_parts(_t(im), _t(pts)[None], kind,
                                            crop=crop)
            want = jinterp.sample_dense_parts(jnp.asarray(im),
                                              jnp.asarray(pts), kind, crop)
            for g, w in zip(got, want, strict=True):
                _close(g[0], w, SAMPLER_REL, (kind, crop))


# -- ssm/base: dwdp_at --------------------------------------------------------
@pytest.mark.parametrize("key", ["8", "6", "spline"])
def test_dwdp_at_matches_jax(key):
    """The exact warp Jacobian at a random state, for the homography, the
    affine SSM and the spline, each of 3 states at once."""
    ssm, jssm = mtf_tpu_torch.get_ssm(key, device="cpu"), jget_ssm(key)
    rng = np.random.default_rng(7)
    state = rng.normal(0, 0.02, (3, ssm.dof)).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (3, 20, 2)).astype(np.float32)
    got = ssm.dwdp_at(_t(state), _t(pts)).numpy()
    assert got.shape == (3, 20, 2, ssm.dof)
    want = np.asarray(jax.jit(jax.vmap(jssm.dwdp_at))(jnp.asarray(state),
                                                      jnp.asarray(pts)))
    for b in range(3):
        assert (np.linalg.norm(got[b] - want[b])
                <= NORM_REL * np.linalg.norm(want[b])), b
    # at identity, the generators' Jacobian
    if key != "spline":
        zero = ssm.identity((3,))
        np.testing.assert_allclose(ssm.dwdp_at(zero, _t(pts)).numpy(),
                                   ssm.dwdp_identity(_t(pts)).numpy(),
                                   rtol=1e-5, atol=1e-6)


# -- sm/core and the package exports ------------------------------------------
CORNERS = np.array([[[30.3, 20.6], [80.2, 21.1], [79.7, 70.4], [30.9, 69.8]],
                    [[50.4, 30.2], [100.7, 30.6], [100.1, 75.3],
                     [49.6, 74.9]]], np.float32)


def test_core_helpers_and_reinitialize_match_jax():
    """`image_pts` and `sample_patch` at a moved state, and
    `SearchMethod.reinitialize` on a new frame and corners, against the
    JAX package's on each tracker."""
    img, img2 = _scene(), _scene(seed=1)
    rng = np.random.default_rng(8)
    dp = rng.normal(0, 0.02, (2, 8)).astype(np.float32)
    sm = tcreate("fclk", "ssd", "8", resx=8, resy=8, device="cpu")
    jsm = jcreate("fclk", "ssd", "8", resx=8, resy=8)
    st = sm.initialize(img, CORNERS)
    st = st._replace(ssm_state=_t(dp))
    pts = core.image_pts(sm.ssm, st)
    patch = core.sample_patch(_t(img2), pts, sm.prm)
    re = sm.reinitialize(img2, CORNERS[::-1].copy())
    for b in range(2):
        jst = jsm.initialize(jnp.asarray(img), jnp.asarray(CORNERS[b]))
        jst = jst._replace(ssm_state=jnp.asarray(dp[b]))
        jpts = jcore.image_pts(jsm.ssm, jst)
        _close(pts[b], jpts, SAMPLER_REL, "image_pts")
        _close(patch[b], jcore.sample_patch(jnp.asarray(img2), jpts,
                                            jsm.prm), SAMPLER_REL, "patch")
        jre = jsm.reinitialize(jnp.asarray(img2),
                               jnp.asarray(CORNERS[1 - b]))
        _close(re.am_state.template[b], jre.am_state.template, SAMPLER_REL,
               "template")
        _close(sm.corners(re)[b], jsm.corners(jre), SAMPLER_REL, "corners")
        np.testing.assert_array_equal(re.ssm_state[b], jre.ssm_state)


def test_package_exports():
    from mtf_tpu_torch import ops
    assert ops.warp is warp and ops.interp is interp
    assert issubclass(type(tcreate("fclk", device="cpu")), SearchMethod)
    assert TrackerState is core.TrackerState
    assert SMParams().extra == {} and SMParams(extra={"a": 1}).extra["a"]
    assert mtf_tpu_torch.get_am("ncc").name == "ncc"
    assert mtf_tpu_torch.get_ssm("6", device="cpu").dof == 6


# -- fault 19: InvalidArgument on bad keys ------------------------------------
BAD_KEYS = {
    "am": (("fclk", "nope", "8"), {}),
    "ssm": (("fclk", "ssd", "99"), {}),
    "ilm": (("fclk", "ssd", "8", "nope"), {}),
    "casc": (("casc", "ssd", "8"), {}),
    "prl": (("prl", "ssd", "8"), {}),
    "sm": (("nope", "ssd", "8"), {}),
}


@pytest.mark.parametrize("what", list(BAD_KEYS))
def test_bad_keys_raise_invalid_argument(what):
    """The port raises its `InvalidArgument` (a `ValueError`, as JAX's)
    for each bad key; where the JAX factory raises its own
    `InvalidArgument` the class matches it by name and bases. An unknown
    ILM key raises a bare `KeyError` in JAX (not copied)."""
    args, kw = BAD_KEYS[what]
    with pytest.raises(InvalidArgument) as got:
        tcreate(*args, device="cpu", **kw)
    assert isinstance(got.value, ValueError)
    with pytest.raises(Exception) as want:
        jcreate(*args, **kw)
    if what == "ilm":
        assert type(want.value) is KeyError
        return
    jcls = type(want.value)
    assert jcls.__name__ == "InvalidArgument"
    assert ([c.__name__ for c in type(got.value).__mro__]
            == [c.__name__ for c in jcls.__mro__])


# -- fault 20: the bridge's reader leaves the segment to the writer -----------
# a reader process: the port's bridge module alone (numpy and the standard
# library), loaded from its file; prints the frame id and the frame's bytes
READER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("bridge", sys.argv[1])
bridge = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bridge)
r = bridge.SharedImageReader(sys.argv[2], timeout=5.0)
fid, frame = r.read_latest()
r.close()
print(fid, frame.tobytes().hex())
"""


def test_second_reader_attaches_after_the_first_exits():
    """A writer publishes a frame; a reader process (a new interpreter)
    reads it and exits; a second one still attaches and reads the same
    frame; the writer alone unlinks the segment on `close()`."""
    import os
    import subprocess
    import sys
    from mtf_tpu_torch import bridge
    name = f"pgap{os.getpid()}"
    frame = _scene(12, 16)
    w = bridge.SharedImageWriter(name, 12, 16, 1, n_slots=2)
    try:
        fid = w.write(frame)
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, "-c", READER, bridge.__file__, name],
                capture_output=True, text=True, timeout=60, check=True)
            got_id, hexed = out.stdout.split()
            assert int(got_id) == fid, out.stderr
            np.testing.assert_array_equal(
                np.frombuffer(bytes.fromhex(hexed), np.float32).reshape(
                    frame.shape), frame)
            assert "leaked" not in out.stderr, out.stderr
    finally:
        w.close()
    with pytest.raises(FileNotFoundError):
        bridge.SharedImageReader(name, timeout=0.0)


# -- the sub-tracker grid without a crop --------------------------------------
NOCROP = {
    # the JAX package's own no-crop test's configuration
    # (tests/test_grid_composite.py:188): gather taps, the generic path
    "iclk": dict(grid_res=4, grid_sm="iclk", grid_ssm="2", max_iters=4),
    # the chain kernel's plain form on the shared frame
    "fclk": dict(grid_res=4, grid_sm="fclk", grid_ssm="2", max_iters=4,
                 epsilon=0.0, interp="linear_mm",
                 coarse_pt_iters=((2, 2),)),
}


@functools.cache
def _grid_frames():
    img = _scene()
    return img, np.roll(img, (1, 1), (0, 1)).astype(np.float32)


@functools.cache
def _jax_grid(name):
    """The JAX grid's corners after one update from its init."""
    img, f2 = _grid_frames()
    fl = JFleet(jcreate("grid", "ssd", "8", **NOCROP[name]))
    return np.asarray(fl.corners(fl.update(jax_init(fl, img, CORNERS), f2)))


@pytest.fixture(scope="module")
def jax_grids():
    side_by_side([functools.partial(_jax_grid, n) for n in NOCROP])
    return {n: _jax_grid(n) for n in NOCROP}


def test_factory_builds_the_no_crop_grid():
    """The JAX package's no-crop call builds the port's `SubTrackerGrid`;
    fclk and esm sub-trackers build without a crop too."""
    sm = tcreate("grid", "ssd", "8", grid_res=4, grid_sm="iclk",
                 grid_ssm="2", max_iters=4, device="cpu")
    assert isinstance(sm, SubTrackerGrid) and sm.sub.prm.crop is None
    for sub in ("fclk", "esm"):
        g = tcreate("grid", "ssd", "8", grid_res=4, grid_sm=sub,
                    interp="linear_mm", device="cpu")
        assert isinstance(g, SubTrackerGrid) and g.sub.name == sub


@pytest.mark.parametrize("name", list(NOCROP))
def test_no_crop_grid_matches_jax(name, jax_grids, monkeypatch):
    """One update within GRID_TOL_PX of the JAX grid's; the fused
    sub-trackers read the frame (and its blur) shared at a batch stride
    of 0, one chain call per iteration, never a frame per sub-tracker."""
    img, f2 = _grid_frames()
    sm = tcreate("grid", "ssd", "8", device="cpu", **NOCROP[name])
    use_indices(sm, jax_fit_indices(1, n_pts=16, sample=4))
    fl = TrackerFleet(sm)
    st = fl.initialize(img, CORNERS)
    windows, chain = [], lk_mod.lk_fused_chain

    def spy(window, *a, **kw):
        windows.append(window)
        return chain(window, *a, **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    got = fl.corners(fl.update(st, f2)).numpy()
    assert np.abs(got - jax_grids[name]).max() <= GRID_TOL_PX
    if name == "iclk":
        assert not windows
        return
    assert len(windows) == 4                     # 2 coarse + 2 full
    for win in windows:
        assert tk.shared_window(win) and win.shape == (32,) + img.shape


def test_no_crop_update_multi_runs_one_call_per_parent_frame(monkeypatch):
    """`update_multi` with no crop: sub-tracker b·P + p reads frame b by
    index, the chain kernel once per parent frame and iteration on that
    frame at a batch stride of 0; on copies of one frame it is `update`,
    bit for bit."""
    img, f2 = _grid_frames()
    sm = tcreate("grid", "ssd", "8", device="cpu", **NOCROP["fclk"])
    st = sm.initialize(img, CORNERS)
    windows, chain = [], lk_mod.lk_fused_chain

    def spy(window, *a, **kw):
        windows.append(window)
        return chain(window, *a, **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    got = sm.corners(sm.update_multi(st, np.stack([f2, f2])))
    assert len(windows) == 2 * 4
    assert all(tk.shared_window(w) and w.shape[0] == 16 for w in windows)
    monkeypatch.setattr(lk_mod, "lk_fused_chain", chain)
    assert torch.equal(got, sm.corners(sm.update(st, f2)))


def test_plain_chain_form_reads_a_shared_window_as_copies():
    """The chain kernel's plain form on a frame shared at a batch stride of
    0 (one product, no copy per tracker) against the same frame copied
    per tracker."""
    rng = np.random.default_rng(9)
    frame = _t(_scene(40, 56))
    b, n = 6, 16
    M0 = torch.eye(3).repeat(b, 1, 1)
    M0[:, :2, 2] = _t(rng.uniform(10, 30, (b, 2)).astype(np.float32))
    M0[:, 0, 0] = M0[:, 1, 1] = 8.0
    g = warp.unit_square_grid(4, 4)
    ph = torch.cat([g.T, torch.ones(1, n)]).expand(b, 3, n).contiguous()
    templ = _t(rng.uniform(0, 255, (b, n)).astype(np.float32))
    gens = mtf_tpu_torch.get_ssm("2", device="cpu").generators
    shared = frame.expand(b, *frame.shape)
    assert tk.shared_window(shared)
    a = tk.lk_fused_chain_ref(shared, M0, gens, ph, templ)
    c = tk.lk_fused_chain_ref(shared.contiguous(), M0, gens, ph, templ)
    for x, y in zip(a, c, strict=True):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-3)
