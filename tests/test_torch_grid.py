"""Port parity, slice 3's grid layer: `solve2x2`, the weighted homography
DLT, RANSAC and LMedS (and the median-flow dispatch), the grid pyramid,
the grid-flow kernel K5 (plain form) and one `GridTracker` update, each
held against the JAX package on the same inputs (made with numpy).

The random minimal samples cannot match (threefry against a
`torch.Generator`), so the port's fits are handed the JAX package's
index draw wherever the two are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import linalg as jlinalg
from mtf_tpu.ops import ransac as jransac
from mtf_tpu.ops import warp as jwarp
from mtf_tpu.ops.pallas.grid_flow import grid_flow_fused
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import linalg, ransac
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.kernels import grid_flow as gf
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm import grid as tgrid
from mtf_tpu_torch.ssm import get_ssm
from test_torch_fleet import _scene
from test_torch_gpu import k5_inputs

# the bench row's grid (bench_extra.py:363-379) without the refiner
GRID_CFG = dict(resx=50, resy=50, max_iters=10, epsilon=0.0,
                interp="linear_mm", crop=160, grid_sub_iters=(1, 8),
                grid_coarse_stride=2)
GRID_CORNERS = np.array([[[110, 80], [210, 80], [210, 160], [110, 160]],
                         [[30, 40], [110, 44], [106, 120], [34, 116]]],
                        np.float32)
# the JAX package's own tolerance between its two grid paths
# (tests/test_r5_features.py:112)
GRID_TOL_PX = 0.1


def _t(a):
    return torch.tensor(np.asarray(a))


def jax_fit_indices(n_updates, seed=0, n_hyps=64, n_pts=100, sample=4):
    """The (n_hyps, sample) index draw of each of a JAX grid tracker's
    first updates: the key chain of `GridTracker._update` (and of
    `SubTrackerGrid._update`); `sample` is the SSM's minimal sample, 4 for
    the homography."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_updates):
        key, k_fit = jax.random.split(key)
        out.append(_t(jransac.hyp_indices(k_fit, n_hyps, n_pts, sample)))
    return out


def use_indices(grid_sm, indices):
    """Make the port's grid draw `indices[step]` at each update."""
    grid_sm._hyp_indices = lambda step, n_pts: indices[step]


# -- linalg, DLT, RANSAC --------------------------------------------------
def test_solve2x2_matches_jax():
    rng = np.random.default_rng(0)
    H = rng.normal(0, 1, (40, 2, 2)).astype(np.float32)
    H[:10] = H[:10] @ H[:10].transpose(0, 2, 1) + 1e-3 * np.eye(2)
    H[10] = 0.0                                    # det 0: sign(0) = 0
    H[11] = [[1e-7, 0], [0, 1e-7]]                 # tiny positive det
    H[12] = [[1e-7, 0], [0, -1e-7]]                # tiny negative det
    b = rng.normal(0, 1, (40, 2)).astype(np.float32)
    got = linalg.solve2x2(_t(H), _t(b)).numpy()
    want = np.asarray(jax.vmap(jlinalg.solve2x2)(jnp.asarray(H),
                                                 jnp.asarray(b)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def _correspondences(rng, b=3, n=100, n_out=20):
    """b trackers of n correspondences through random homographies of the
    template frame, with n_out planted outliers each."""
    src = rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32)
    ssm = get_ssm("8", device="cpu")
    states = torch.tensor(rng.normal(0, 0.05, (b, 8)), dtype=torch.float32)
    dst = ssm.warp_pts(states, _t(src)).numpy()
    dst += rng.normal(0, 1e-3, dst.shape).astype(np.float32)
    for i in range(b):
        out = rng.choice(n, n_out, replace=False)
        dst[i, out] += rng.uniform(-0.3, 0.3, (n_out, 2))
    return src, dst.astype(np.float32)


def test_weighted_homography_dlt_matches_jax():
    rng = np.random.default_rng(1)
    src, dst = _correspondences(rng)
    w = rng.uniform(0, 1, src.shape[:2]).astype(np.float32)
    w[:, :5] = 0.0
    w[0, 5] = -1.0                                 # clamped to 0
    got = W.homography_dlt(_t(src), _t(dst), _t(w)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jwarp.homography_dlt))(src, dst, w))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def fits():
    """JAX RANSAC / LMedS fits (with and without external weights) on
    20 planted outliers of 100 points, for 3 trackers, with the index
    draw of PRNGKey(0)."""
    rng = np.random.default_rng(2)
    src, dst = _correspondences(rng)
    w_ext = (rng.uniform(0, 1, src.shape[:2]) > 0.1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ssm = jget_ssm("8")
    out = {"src": src, "dst": dst, "w_ext": w_ext,
           "idx": _t(jransac.hyp_indices(key, 64, 100, 4))}
    fns = {"ransac": lambda s, d, w: jransac.ransac_fit(ssm, s, d, key, 64,
                                                        0.05, w),
           "lmeds": lambda s, d, w: jransac.lmeds_fit(ssm, s, d, key, 64, w)}
    for name, fn in fns.items():
        fit = jax.jit(jax.vmap(fn))
        # unit external weights are the unweighted fit
        for weighted, w in ((False, np.ones_like(w_ext)), (True, w_ext)):
            out[name, weighted] = tuple(np.asarray(a)
                                        for a in fit(src, dst, w))
    return out


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("method", ["ransac", "lmeds"])
def test_robust_fit_with_jax_indices_matches_jax(fits, method, weighted):
    """The state and the inlier weights within 1e-4, and the outliers
    rejected."""
    ssm = get_ssm("8", device="cpu")
    w = _t(fits["w_ext"]) if weighted else None
    state, inl = ransac.robust_fit(ssm, _t(fits["src"]), _t(fits["dst"]),
                                   fits["idx"], method=method,
                                   inlier_thresh=0.05, weights=w)
    want_state, want_w = fits[method, weighted]
    np.testing.assert_allclose(state.numpy(), want_state, rtol=0, atol=1e-4)
    np.testing.assert_allclose(inl.numpy(), want_w, rtol=0, atol=1e-4)
    assert float(inl.sum(-1).min()) >= 60


def test_ransac_per_tracker_threshold_and_lsq():
    """A (B,) threshold equals per-tracker scalar calls; "median" is the
    median-flow similarity (no draw); any other estimator name is the
    weighted least-squares fit."""
    rng = np.random.default_rng(3)
    src, dst = _correspondences(rng)
    ssm = get_ssm("8", device="cpu")
    idx = ransac.hyp_indices(torch.Generator().manual_seed(0), 64, 100, 4)
    th = torch.tensor([0.02, 0.05, 0.1])
    st, w = ransac.ransac_fit(ssm, _t(src), _t(dst), idx, th)
    for i in range(3):
        st_i, w_i = ransac.ransac_fit(ssm, _t(src[i:i + 1]),
                                      _t(dst[i:i + 1]), idx, float(th[i]))
        np.testing.assert_allclose(st[i].numpy(), st_i[0].numpy(),
                                   atol=1e-6)
        assert torch.equal(w[i], w_i[0])
    st_l, w_l = ransac.robust_fit(ssm, _t(src), _t(dst), None, method="lsq")
    assert torch.equal(w_l, torch.ones(3, 100))
    np.testing.assert_allclose(st_l.numpy(),
                               ssm.fit_pts(_t(src), _t(dst)).numpy(),
                               atol=1e-6)
    st_m, w_m = ransac.robust_fit(ssm, _t(src), _t(dst), None,
                                  method="median")
    assert torch.equal(w_m, torch.ones(3, 100))
    np.testing.assert_array_equal(
        st_m.numpy(), ransac.median_flow_fit(ssm, _t(src), _t(dst))[0].numpy())


def test_fit_pts_and_set_region_match_jax():
    rng = np.random.default_rng(4)
    corners = GRID_CORNERS + rng.uniform(-3, 3, GRID_CORNERS.shape).astype(
        np.float32)
    frame = _scene()
    j = jcreate("fclk", "ssd", "8", resx=8, resy=8)
    t = tcreate("fclk", "ssd", "8", device="cpu", resx=8, resy=8,
                interp="linear_mm", crop=64, epsilon=0.0)
    st = t.initialize(frame, GRID_CORNERS)
    got = t.set_region(st, _t(corners)).ssm_state.numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda c0, c: j.set_region(j.initialize(frame, c0), c).ssm_state))(
            GRID_CORNERS, corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    # below 8 DOF the base fit dispatches by DOF, as the JAX package's: the
    # affine DLT at 5-7, the similitude DLT below (ASRT and Similitude keep
    # the base fit), here on set_region's template-frame correspondences
    src = st.region.base_corners
    dst = W.apply_warp(torch.linalg.inv(st.region.norm_mat), _t(corners))
    for key in ("5", "4"):
        fit = get_ssm(key, device="cpu").fit_pts(src, dst)
        want = np.asarray(jax.vmap(jget_ssm(key).fit_pts)(src.numpy(),
                                                           dst.numpy()))
        np.testing.assert_allclose(fit.numpy(), want, rtol=0, atol=1e-5)


# -- pyramid and K5 -------------------------------------------------------
def test_pyramid_matches_jax_resize():
    """The antialiased bilinear resize is what jax.image.resize(...,
    "linear") computes (a plain bilinear one moves it by grey levels)."""
    frame = _scene(0, 480, 640)
    sm = tcreate("grid", "ssd", "8", device="cpu", **GRID_CFG)
    got = sm._pyr_frames(torch.tensor(frame))[1].numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(frame), (240, 320),
                                       "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


K5_P, K5_ITERS = 8, 4


def _k5_ref(win, pts, templ, scale, n, iters=K5_ITERS):
    """The plain K5 on numpy operands -> (B, P, 2) numpy."""
    return gf.grid_flow_ref(*(_t(a) for a in (win, pts, templ, scale)),
                            n, iters).numpy()


@pytest.mark.parametrize("n", [16, 64])
def test_plain_k5_matches_jax_xla_path(n):
    """Against `GridTracker._track_patches_mm` (the XLA joint loop) on
    each window as the frame, with norm_mat the pure scale `scale`: the
    same points, templates and math in float32. Measured at most 1.7e-8
    template units apart; bound 1e-6."""
    win, pts, templ, scale, _ = k5_inputs(n)
    got = _k5_ref(win, pts, templ, scale, n)
    trk = jcreate("grid", "ssd", "8", interp="linear_mm", use_pallas=False)
    norm = np.diag([scale[0], scale[0], 1.0]).astype(np.float32)
    for i in range(len(win)):
        base = (pts[i].T / scale[0]).reshape(K5_P, n, 2)
        want = np.asarray(trk._track_patches_mm(
            jnp.asarray(win[i]), jnp.asarray(norm), jnp.asarray(base),
            jnp.asarray(templ[i].reshape(K5_P, n, 1)), K5_ITERS, crop=None))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)


# The Pallas kernel rounds its tap weights to bf16 for the MXU (a weight
# 1 - fx is off by up to 2^-9), which the plain form, given the same
# bf16-rounded window, does not. On these inputs (4 iterations, disp up
# to 0.011 template units) the two measured 9.1e-5 template units apart
# at most (n = 16) and 4.9e-5 (n = 64), about 2e-3 px at scale 20.
# Bound with 2x headroom.
K5_PALLAS_TOL = 2e-4


@pytest.mark.parametrize("n", [16, 64])
def test_plain_k5_matches_pallas_interpret(n):
    win, pts, templ, scale, _ = k5_inputs(n)
    win = np.asarray(jnp.asarray(win).astype(jnp.bfloat16).astype(
        jnp.float32))
    got = _k5_ref(win, pts, templ, scale, n)
    for i in range(len(win)):
        want = np.asarray(grid_flow_fused(
            jnp.asarray(win[i]), jnp.asarray(pts[i]), jnp.asarray(templ[i]),
            jnp.float32(scale[i]), n, K5_ITERS, True, interpret=True)).T
        np.testing.assert_allclose(got[i], want, rtol=0, atol=K5_PALLAS_TOL)


def test_k5_recovers_the_shift():
    """Without ZNCC (raw templates, plain Gauss-Newton) the flow moves
    each patch onto its template: disp * scale lands on the planted
    shift, all but a few patches that stall on a kink of the bilinear
    surface. (With ZNCC the JAX package pairs a standardised residual with
    the raw gradient, so each step is the Gauss-Newton step divided by
    the patch's std: ROADMAP Queue 3.)"""
    win, pts, templ, scale, shift = k5_inputs(64, seed=6, zncc=False)
    got = gf.grid_flow_ref(*(_t(a) for a in (win, pts, templ, scale)), 64,
                           20, zncc=False).numpy() * scale[:, None, None]
    err = np.abs(got - shift).max(-1)
    assert np.isfinite(err).all() and np.mean(err < 0.05) >= 0.85, err


def test_grid_flow_dispatches_on_device():
    """CPU tensors take the plain form and count no launch; other
    devices raise (no fallback)."""
    args = [_t(a) for a in k5_inputs(16)[:4]]
    before = gf.grid_flow.launches
    np.testing.assert_array_equal(gf.grid_flow(*args, 16, 2).numpy(),
                                  gf.grid_flow_ref(*args, 16, 2).numpy())
    assert gf.grid_flow.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        gf.grid_flow(*(a.to("meta") for a in args), 16, 2)


# -- GridTracker ----------------------------------------------------------
@pytest.fixture(scope="module")
def grid_ref():
    """One JAX grid update on both paths (XLA, and the Pallas kernel in
    interpret mode) from the bench row's grid configuration."""
    frame = _scene(0)
    f2 = np.roll(frame, (3, 2), (0, 1))
    out = {"frame": frame, "f2": f2}
    for name, up in (("xla", False), ("pallas", True)):
        fl = JFleet(jcreate("grid", "ssd", "8", use_pallas=up, **GRID_CFG))
        st = fl.update(fl.initialize(frame, GRID_CORNERS), f2)
        out[name] = np.asarray(fl.corners(st))
        out[name, "inl"] = np.asarray(st.extra.inlier_mask)
    return out


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_grid_update_matches_jax(grid_ref, jax_path):
    sm = tcreate("grid", "ssd", "8", device="cpu", **GRID_CFG)
    use_indices(sm, jax_fit_indices(1))
    fl = TrackerFleet(sm)
    st = fl.update(fl.initialize(grid_ref["frame"], GRID_CORNERS),
                   grid_ref["f2"])
    got = fl.corners(st).numpy()
    assert np.abs(got - grid_ref[jax_path]).max() < GRID_TOL_PX
    if jax_path == "xla":
        np.testing.assert_array_equal(st.extra.inlier_mask.numpy(),
                                      grid_ref["xla", "inl"])


def test_grid_update_runs_two_k5_levels(grid_ref, monkeypatch):
    """Level 1 first (16 points per patch, 8 iterations, 96 px window),
    then level 0 (64 points, 1 iteration, 160 px window): one grid-flow
    call each, for all trackers and patches."""
    sm = tcreate("grid", "ssd", "8", device="cpu", **GRID_CFG)
    st = sm.initialize(grid_ref["frame"], GRID_CORNERS)
    assert st.extra.templates.shape == (2, 2, 100, 64, 1)
    calls = []

    def spy(win, pts, templ, scale, n, n_iters, zncc=True, kind="linear"):
        calls.append((tuple(win.shape), tuple(pts.shape), n, n_iters, zncc,
                      kind))
        return gf.grid_flow(win, pts, templ, scale, n, n_iters, zncc, kind)

    monkeypatch.setattr(tgrid, "grid_flow", spy)
    st = sm.update(st, grid_ref["f2"])
    assert calls == [((2, 96, 96), (2, 2, 1600), 16, 8, True, "linear"),
                     ((2, 160, 160), (2, 2, 6400), 64, 1, True, "linear")]
    assert int(st.extra.step) == 1


def test_grid_draw_is_a_function_of_seed_and_step():
    sm = tcreate("grid", "ssd", "8", device="cpu", **GRID_CFG)
    a, b = sm._hyp_indices(0, 100), sm._hyp_indices(0, 100)
    assert torch.equal(a, b) and a.shape == (64, 4)
    assert not torch.equal(a, sm._hyp_indices(1, 100))
    assert int(a.min()) >= 0 and int(a.max()) < 100


@pytest.mark.parametrize("key,est,levels", [
    ("grid", "ransac", 2), ("ransac", "ransac", 2), ("rnsc", "ransac", 2),
    ("lms", "lmeds", 2), ("grid", "ransac", 3)])
def test_grid_factory_keys(key, est, levels):
    kw = dict(GRID_CFG, grid_sm="cv") if levels == 3 else GRID_CFG
    t = tcreate(key, "ssd", "8", device="cpu", **kw)
    j = jcreate(key, "ssd", "8", **kw)
    assert type(t).__name__ == type(j).__name__ == "GridTracker"
    assert t.grid.estimator == j.grid.estimator == est
    assert t.grid.pyramid_levels == j.grid.pyramid_levels == levels
    assert t.grid.sub_iters == j.grid.sub_iters == (1, 8)


@pytest.mark.parametrize("key,kw,queue", [
    ("grid", {"grid_sm": "tld"}, "Queue 1c"),
    ("gric", {}, "Queue 1c"), ("pfrk", {}, "Queue 1c"),
    ("casc", {"multi_cfg": "multi.cfg"}, "Queue 1, slice 8")])
def test_grid_rejects_unported(key, kw, queue):
    """What stays unported raises naming its queue: a grid of sub-trackers
    that are not ported (the grid of ported sub-trackers is held against
    the JAX package in `test_torch_ssm_fleet.py`), the shorthands with
    ICLK or PF members, composites from a multi.cfg file. (The rigid and
    f2f flows, forward-backward masking and the gather kinds are held
    against the JAX package in `test_torch_grid_family.py`.)"""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {queue}"):
        tcreate(key, "ssd", "8", device="cpu", **{**GRID_CFG, **kw})
