"""Port parity, slice 9's search methods: the particle filter
(`mtf_tpu_torch/sm/pf.py`) and nearest-neighbour search (`sm/nn.py`)
against the JAX package's (`mtf_tpu/sm/pf.py`, `sm/nn.py`), with the SSM
sampling helpers they call and the factory keys that build them.

The port's draws are its own; here every update is handed the JAX
package's (`jax_pf_draws`, `jax_nn_draws`: the JAX key schedule rebuilt
from `pf.py:476-483`, `:370-383`, `:579` and `ssm/base.py:194-214`, and
`nn.py:144-153`, `:251-253`) through the port's one overridable draw
method per search method, and both packages start from the JAX init
(`convert.to_torch`). 16x16 templates, B = 2, P = 48, K = 64 on the test
scene; the corners sit off the pixel grid (ROADMAP Queue 3, item 2).

Tolerances: particles within 1e-5 of their scale, log-weights within
1e-4 (relative where larger than 1), the resampler's indices equal,
corners within 0.05 px (the chain kernel's parity tolerance, ROADMAP
North star); NN's dataset features within 1e-4 of their norm. The JAX
references are computed side by side (`test_torch_fleet.side_by_side`).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm.nn import NN
from mtf_tpu_torch.sm.pf import PF, PFDraw, systematic_indices
from mtf_tpu_torch.ssm import get_ssm as tget_ssm
from mtf_tpu_torch.utils import synth as tsynth
from test_torch_fleet import (CORNER_TOL, CORNERS, _scene, jax_init,
                              side_by_side)
from test_torch_grid import jax_fit_indices, use_indices

OFF_GRID = (CORNERS[:2] + np.float32([0.31, 0.27])).astype(np.float32)
SHIFT = (1, 2)
BASE = dict(resx=16, resy=16, interp="linear_mm", crop=96)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this module: beside XLA's compiles its
    OpenMP pool slows both (the JAX references here are compiles)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    frame = _scene()
    return frame, np.roll(frame, SHIFT, (0, 1))


def _close(got, want, rel, floor=0.0):
    """|got - want| within rel of want's largest magnitude (or of
    `floor`, if larger)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), floor,
                                                 1e-30)


def _log_w_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()


# -- the JAX package's draws --------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _pf_draw(key, P, S, D):
    key, k_prop, k_res, k_distr, _ = jax.random.split(key, 5)
    prop = jax.vmap(lambda k: jax.random.normal(k, (S,), jnp.float32))(
        jax.random.split(k_prop, P))
    return key, prop, jax.random.gumbel(k_distr, (P, D), jnp.float32), \
        jax.random.uniform(k_res, ())


@functools.cache
def jax_pf_draws(seed, steps, P, S, D):
    """The PF's draws of `steps` updates from `PRNGKey(seed)`: per update
    `key, k_prop, k_res, k_distr, k_am = split(key, 5)`, each particle's
    (S,) normals from `split(k_prop, P)`, `categorical`'s Gumbel noise
    (P, D) from k_distr, the resampler's `uniform(k_res, ())`."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, prop, g, u0 = _pf_draw(key, P, S, D)
        out.append(PFDraw(torch.tensor(np.asarray(prop)),
                          torch.tensor(np.asarray(g)),
                          torch.tensor(np.asarray(u0)), torch.zeros((P, 0))))
    return out


@functools.cache
def jax_nn_draws(seed, K, A, steps, S):
    """NN's dataset normals (K, S) from `PRNGKey(seed)` and each update's
    online additions (A, S), `key, k_add = split(key)` from
    `PRNGKey(seed + 1)`."""
    data = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (K, S),
                                        jnp.float32))
    key, adds = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps):
        key, k_add = jax.random.split(key)
        adds.append(np.asarray(jax.random.normal(k_add, (A, S), jnp.float32)))
    return data, adds


def inject(sm, seed=0, steps=4):
    """Hand every PF and NN of `sm` (a tracker or composite) the JAX
    package's draws."""
    for m in sm.modules():
        if isinstance(m, PF):
            d = jax_pf_draws(seed, steps, m.pf.n_particles, m.ssm.dof,
                             max(1, len(m.pf.ssm_sigmas)))
            m._draw = lambda step, d=d: d[step]
        elif isinstance(m, NN):
            data, adds = jax_nn_draws(seed, m.nn.n_samples,
                                      m.nn.n_samples_to_add, steps,
                                      m.ssm.dof)
            m._draw = (lambda step, n, data=data, adds=adds: torch.tensor(
                data if step is None else adds[step]))
    return sm


def test_gumbel_draw_is_jax_categorical():
    """`_draw_sigmas`' Gumbel trick on the JAX draw picks what
    `jax.random.categorical` picks for the same key and logits."""
    key = jax.random.PRNGKey(3)
    logits = jnp.log(jnp.array([0.2, 0.5, 0.3]))
    want = np.asarray(jax.random.categorical(key, logits, shape=(64,)))
    g = np.asarray(jax.random.gumbel(key, (64, 3), jnp.float32))
    np.testing.assert_array_equal(np.argmax(g + np.asarray(logits), -1),
                                  want)


def test_systematic_indices_match_jax():
    """The resampler: `searchsorted` (left) of (i + u0) / P in the
    cumulative weights, clipped, as the JAX package's `resample`."""
    rng = np.random.default_rng(0)
    lw = rng.normal(0, 3, (3, 50)).astype(np.float32)
    lw = lw - np.log(np.exp(lw).sum(-1, keepdims=True))
    u0 = np.float32(0.37)

    def jidx(lw):
        cum = jnp.cumsum(jnp.exp(lw))
        u = (jnp.arange(50, dtype=jnp.float32) + u0) / 50
        return jnp.clip(jnp.searchsorted(cum, u), 0, 49)
    want = np.stack([np.asarray(jidx(x)) for x in lw])
    got = systematic_indices(torch.tensor(lw), torch.tensor(u0)).numpy()
    np.testing.assert_array_equal(got, want)


# -- SSM sampling helpers -----------------------------------------------------

SAMPLER_KEYS = ("8", "6", "sl3")
_SAMPLER = {}


def _sampler_inputs(key):
    rng = np.random.default_rng(1)
    S = tget_ssm(key, device="cpu").dof
    state = (rng.normal(0, 0.02, S)).astype(np.float32)
    prev = (state + rng.normal(0, 0.01, S)).astype(np.float32)
    sigma = np.full(S, 0.01, np.float32)
    states = (state + rng.normal(0, 0.01, (12, S))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    w = w / w.sum()
    pts = rng.uniform(-0.5, 0.5, (30, 2)).astype(np.float32)
    return state, prev, sigma, states, w, pts


def _sampler_jax(key):
    """The JAX SSM's samplers on `_sampler_inputs` (SL3: the Karcher mean
    alone), with the normals of their key."""
    js = jget_ssm(key)
    state, prev, sigma, states, w, pts = _sampler_inputs(key)
    k = jax.random.PRNGKey(5)

    @jax.jit
    def ref():
        out = [jax.random.normal(k, (js.dof,), jnp.float32),
               js.mean_of_samples(states, w)]
        if key == "sl3":
            return out
        return out + [js.random_walk(k, state, sigma, True),
                      js.random_walk(k, state, sigma, False),
                      js.auto_regression1(k, state, prev, sigma, 0.5, True),
                      js.auto_regression1(k, state, prev, sigma, 0.5, False),
                      js.scale_state(state, 0.3),
                      js.state_sigma_from_pixel_sigma(2.0, pts)]
    _SAMPLER[key] = [np.asarray(x) for x in ref()]


@pytest.mark.parametrize("key", SAMPLER_KEYS)
def test_ssm_samplers_match_jax(key):
    """random_walk and AR(1) (compositional and additive) given the
    normals of the JAX key, scale_state, the weighted mean and the state
    sigmas from a pixel sigma; on SL3 the Karcher mean. A Lie state comes
    out of a float32 matrix log of a warp near the identity, so its
    rounding is absolute: 1e-5 of the state's scale or 1e-5, the
    larger."""
    ts = tget_ssm(key, device="cpu")
    lie = key == "sl3"
    state, prev, sigma, states, w, pts = map(torch.tensor,
                                             _sampler_inputs(key))
    want = _SAMPLER[key]
    noise = torch.tensor(want[0])
    got = [ts.mean_of_samples(states, w)]
    if not lie:
        got += [ts.random_walk(noise, state, sigma, True),
                ts.random_walk(noise, state, sigma, False),
                ts.auto_regression1(noise, state, prev, sigma, 0.5, True),
                ts.auto_regression1(noise, state, prev, sigma, 0.5, False),
                ts.scale_state(state, 0.3),
                ts.state_sigma_from_pixel_sigma(2.0, pts)]
    for g, w_ in zip(got, want[1:]):
        _close(g.numpy(), w_, 1e-5, floor=1.0 if lie else 0.0)


# -- one PF update ------------------------------------------------------------

PF_CASES = {
    # the factory defaults (random walk, compositional, Gaussian,
    # systematic resampling, the weighted mean) with three sampler
    # distributions
    "default_ssm_sigmas": ("pf", "ncc", "8", dict(pf_ssm_sigmas=(
        (0.02,) * 8, (0.005,) * 8, (0.01,) * 8))),
    # with the decimated ranking of the blurred frame (no downsampling,
    # no top-K rescore: the stride-2 scores carry the weights)
    "ar1_additive_am_corner_blur": ("pf", "ssim", "8", dict(
        pf_dynamic_model="ar1", pf_update_type="additive",
        pf_likelihood="am", pf_mean_type="corner", pf_score_stride=2,
        pf_score_blur=True)),
    # with the raw decimated template and the top-K rescore at full
    # resolution in the particle window, on sigmas from one Gauss-Newton
    # step; SSD's residuals keep the reciprocal likelihood's ranking free
    # of ties (`torch.topk` orders ties its own way)
    "reciprocal_none_best_jacobian_top_k": ("pf", "ssd", "8", dict(
        pf_likelihood="reciprocal", pf_resampling="none",
        pf_mean_type="best", pf_jacobian_as_sigma=True, pf_score_stride=2,
        pf_rescore_top_k=16)),
}
# (pf500's measurement, stride 4 on the blurred downsampled frame with
# the top-K rescored in its own window, is the pffc leg's below)
P = 48


def _pf_cfg(name):
    key, am, ssm, kw = PF_CASES[name]
    return key, am, ssm, {**BASE, "pf_n_particles": P, **kw}


_PF = {}


def _pf_jax(name):
    """The JAX fleet's init (numpy) and its state after one update on the
    shifted frame."""
    key, am, ssm, cfg = _pf_cfg(name)
    sm = jcreate(key, am, ssm, **cfg)
    frame, f2 = _frames()
    st0 = jax_init(types.SimpleNamespace(sm=sm), frame, OFF_GRID)
    st1 = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))(st0, f2)
    _PF[name] = (jax.tree.map(np.asarray, st0), jax.tree.map(np.asarray, st1),
                 np.asarray(jax.vmap(sm.corners)(st1)))


@pytest.mark.parametrize("name", list(PF_CASES))
def test_pf_update_matches_jax(name):
    """One PF update from the JAX init with the JAX draws: the particles,
    the log-weights (and so every resampling index), the distribution
    weights and the corners of the mean state."""
    st0, st1, corners = _PF[name]
    key, am, ssm, cfg = _pf_cfg(name)
    sm = inject(tcreate(key, am, ssm, device="cpu", **cfg), steps=1)
    tst = convert.to_torch(st0, device="cpu")
    out = sm.update(tst, _frames()[1])
    _pf_state_close(out.extra, st1.extra)
    got = sm.corners(out).numpy()
    assert np.abs(got - corners).max() < CORNER_TOL
    assert int(out.extra.step) == 1


def _pf_state_close(ex, jex):
    """A PF state against the JAX package's: particles (with the resampler
    taking the same indices), log-weights, distribution weights."""
    _log_w_close(ex.log_weights.numpy(), jex.log_weights)
    _close(ex.particles.numpy(), jex.particles, 1e-5)
    _close(ex.prev_particles.numpy(), jex.prev_particles, 1e-5)
    _close(ex.distr_log_w.numpy(), jex.distr_log_w, 1e-5)


def test_pf_init_matches_jax():
    """The PF's own init: tiled particles, uniform weights and the
    blurred decimated template, and pf500's: blurred and downsampled."""
    for name, ref in (("ar1_additive_am_corner_blur",
                       _PF["ar1_additive_am_corner_blur"][0]),
                      ("pffc_ssim", _LEG["pffc_ssim"][0])):
        key, am, ssm, cfg = (_pf_cfg(name) if name in PF_CASES
                             else LEGS[name])
        sm = tcreate(key, am, ssm, device="cpu", **cfg)
        st = sm.initialize(_frames()[0], OFF_GRID)
        if name in LEGS:
            st, ref = st.members[0], ref.members[0]
        ex = st.extra
        _close(ex.particles.numpy(), ref.extra.particles, 1e-6)
        _log_w_close(ex.log_weights.numpy(), ref.extra.log_weights)
        _close(ex.score_am.template.numpy(), ref.extra.score_am.template,
               1e-5)


# -- NN --------------------------------------------------------------------

K, A = 64, 4
# (the exact search on raw features is the nnic leg's below)
NN_CASES = {"gnn_mi": ("gnn", "mi", "8", dict(gnn_k=6))}


def _nn_cfg(name):
    key, am, ssm, kw = NN_CASES[name]
    return key, am, ssm, {**BASE, "nn_n_samples": K, "nn_add_samples_gap": 1,
                          "nn_n_samples_to_add": A, **kw}


_NN = {}


def _nn_jax(name):
    """The JAX fleet's init (numpy) and its states after two updates."""
    key, am, ssm, cfg = _nn_cfg(name)
    sm = jcreate(key, am, ssm, **cfg)
    frame, f2 = _frames()
    st = jax_init(types.SimpleNamespace(sm=sm), frame, OFF_GRID)
    out = [jax.tree.map(np.asarray, st)]
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    for f in (f2, frame):
        st = upd(st, f)
        out.append(jax.tree.map(np.asarray, st))
    _NN[name] = out


@pytest.mark.parametrize("name", list(NN_CASES))
def test_nn_init_matches_jax(name):
    """The dataset build with the JAX draw: features, their squared
    norms, the stored corrections and the kNN graph."""
    st0 = _NN[name][0].extra
    key, am, ssm, cfg = _nn_cfg(name)
    sm = inject(tcreate(key, am, ssm, device="cpu", **cfg))
    ex = sm.initialize(_frames()[0], OFF_GRID).extra
    _close(ex.feats.numpy(), st0.feats, 1e-4)
    _close(ex.feats_sq.numpy(), st0.feats_sq, 1e-4)
    _close(ex.dps.numpy(), st0.dps, 1e-5)
    if st0.graph is not None:
        np.testing.assert_array_equal(ex.graph.numpy(), st0.graph)


@pytest.mark.parametrize("name", list(NN_CASES))
def test_nn_updates_match_jax(name):
    """Two updates from the JAX init with the JAX draws, each adding A
    online samples (and reconnecting them in the graph): the dataset, the
    ring pointer and the corners after each."""
    states = _NN[name]
    key, am, ssm, cfg = _nn_cfg(name)
    sm = inject(tcreate(key, am, ssm, device="cpu", **cfg))
    tst = convert.to_torch(states[0], device="cpu")
    frame, f2 = _frames()
    for t, f in ((1, f2), (2, frame)):
        tst = sm.update(tst, f)
        jst = states[t]
        ex, jex = tst.extra, jst.extra
        _close(ex.feats.numpy(), jex.feats, 1e-4)
        _close(ex.dps.numpy(), jex.dps, 1e-5)
        np.testing.assert_array_equal(ex.ptr.numpy(), jex.ptr)
        np.testing.assert_array_equal(ex.frame_idx.numpy(), jex.frame_idx)
        if jex.graph is not None:
            np.testing.assert_array_equal(ex.graph.numpy(), jex.graph)
        jc = np.asarray(jax.vmap(jcreate(key, am, ssm, **cfg).corners)(jst))
        assert np.abs(sm.corners(tst).numpy() - jc).max() < CORNER_TOL, t


def test_nn_index_round_trip(tmp_path):
    """save_index / load_index restore the dataset."""
    key, am, ssm, cfg = _nn_cfg("gnn_mi")
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    st = sm.initialize(_frames()[0], OFF_GRID)
    sm.save_index(st, str(tmp_path / "index.pt"))
    other = st._replace(extra=st.extra._replace(
        feats=torch.zeros_like(st.extra.feats)))
    back = sm.load_index(other, str(tmp_path / "index.pt")).extra
    for a, b in zip(back, st.extra):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -- the slice as a whole: 4-frame GT legs ------------------------------------

LEGS = {
    "pffc_ssim": ("pffc", "ssim", "8", dict(
        BASE, pf_n_particles=P, max_iters=5, epsilon=0.0, pf_score_stride=4,
        pf_score_blur=True, pf_score_downsample=True, pf_rescore_top_k=16,
        pf_rescore_crop=64, pf_pix_sigma=2.0, pf_likelihood="am")),
    "nnic_mi": ("nnic", "mi", "8", dict(
        BASE, nn_n_samples=K, max_iters=5, epsilon=0.0, n_bins=32,
        nn_dist_feat="raw", nn_add_samples_gap=2, nn_n_samples_to_add=A)),
}
_LEG = {}


@functools.cache
def _leg_frames():
    frames, gt = tsynth.synthetic_sequence(
        _scene(), OFF_GRID, tget_ssm("8", device="cpu"), n_frames=5,
        sigma_scale=0.004, seed=3)
    return frames.numpy(), gt


def _leg_jax(name):
    key, am, ssm, cfg = LEGS[name]
    sm = jcreate(key, am, ssm, **cfg)
    frames, _ = _leg_frames()
    st = jax_init(types.SimpleNamespace(sm=sm), frames[0], OFF_GRID)
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    out = [jax.tree.map(np.asarray, st)]
    for t in range(1, len(frames)):
        st = upd(st, frames[t])
        out.append((np.asarray(jax.vmap(sm.corners)(st)),
                    jax.tree.map(np.asarray, st.members[0].extra)))
    _LEG[name] = out


# -- pfrk and nnrk against a cascade of the JAX package's own parts ----------
# Every JAX pfrk / nnrk update raises (its cascade reads the RKLT member's
# corners with `image_corners`, which takes no composite state: ROADMAP
# Queue 3, item 13), so the reference is the cascade it means, built from
# the JAX parts: the PF or NN update, RKLT's `set_region` to its corners,
# RKLT's update.
RK_CFG = dict(BASE, max_iters=15, epsilon=0.0, grid_res=4, grid_patch_res=6,
              grid_sub_iters=(1, 3), grid_n_hyps=16)
CASCADE_RK = {"pfrk": dict(RK_CFG, pf_n_particles=P, pf_pix_sigma=1.0),
              "nnrk": dict(RK_CFG, nn_n_samples=K, nn_pix_sigma=1.0)}
_RK = {}


def _rk_jax():
    """One update of pfrk and of nnrk by the JAX parts, from the JAX init
    (the RKLT step compiled once for both: their RKLT members are built
    alike)."""
    frame, f2 = _frames()
    rk_step = None
    for name, cfg in CASCADE_RK.items():
        sm = jcreate(name, "ssd", "8", **cfg)
        first, rk = sm.members
        st = jax_init(types.SimpleNamespace(sm=sm), frame, OFF_GRID)
        if rk_step is None:
            rk_step = jax.jit(jax.vmap(lambda s, c, f: rk.update(
                rk.set_region(s, c), f), in_axes=(0, 0, None)))
        new0 = jax.jit(jax.vmap(first.update, in_axes=(0, None)))(
            st.members[0], f2)
        c = jnp.swapaxes(jax.vmap(first.corners)(new0), 1, 2)
        new1 = rk_step(st.members[1], c, f2)
        _RK[name] = (jax.tree.map(np.asarray, st),
                     np.asarray(jax.vmap(rk.corners)(new1)))


@pytest.mark.parametrize("name", list(CASCADE_RK))
def test_stochastic_rklt_cascade_matches_jax_parts(name):
    """pfrk and nnrk, one update from the JAX init on the JAX draws (the
    PF's or NN's, and RANSAC's): within 0.05 px of the JAX package's PF
    or NN update followed by its RKLT re-seated on those corners and
    updated."""
    st0, want = _RK[name]
    sm = inject(tcreate(name, "ssd", "8", device="cpu", **CASCADE_RK[name]),
                steps=1)
    use_indices(sm.members[1].grid_sm, jax_fit_indices(1, n_hyps=16,
                                                       n_pts=16))
    st = sm.update(convert.to_torch(st0, device="cpu", sm=sm), _frames()[1])
    got = sm.corners(st).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < CORNER_TOL


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    """Every JAX reference of the module, computed side by side first
    (the longest first: each is mostly a trace and an XLA compile)."""
    _leg_frames()
    side_by_side([_rk_jax] + [functools.partial(_leg_jax, n) for n in LEGS]
                 + [functools.partial(_sampler_jax, "sl3")]
                 + [functools.partial(_pf_jax, n) for n in PF_CASES]
                 + [functools.partial(_nn_jax, n) for n in NN_CASES]
                 + [functools.partial(_sampler_jax, k) for k in SAMPLER_KEYS
                    if k != "sl3"])


@pytest.mark.parametrize("name", list(LEGS))
def test_gt_leg_matches_jax(name):
    """pffc/ssim (pf500's measurement model: the blurred, downsampled
    stride-4 ranking, the top-K rescored in its own window, the AM
    likelihood) and nnic/mi (nn1k's exact search on raw features, 32 bins,
    with online additions every other update) fleets over a 4-frame
    synthetic leg, by a donating fleet from the JAX init with the JAX
    draws: on every frame the stochastic stage's state (PF: particles,
    log-weights, so the resampler's indices; NN: the dataset, its ring
    pointer) as the JAX package's and the corners within 0.05 px of its.
    (Their error against the GT is the JAX package's: nnic at 16x16 and
    K = 64 drifts off some targets in both.)"""
    ref = _LEG[name]
    key, am, ssm, cfg = LEGS[name]
    sm = inject(tcreate(key, am, ssm, device="cpu", **cfg))
    frames, gt = _leg_frames()
    fl = TrackerFleet(sm, donate=True)
    st = convert.to_torch(ref[0], device="cpu", sm=sm)
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        want, jex = ref[t]
        ex = st.members[0].extra
        if key == "pffc":
            _pf_state_close(ex, jex)
        else:
            _close(ex.feats.numpy(), jex.feats, 1e-4)
            _close(ex.dps.numpy(), jex.dps, 1e-5)
            np.testing.assert_array_equal(ex.ptr.numpy(), jex.ptr)
        got = fl.corners(st).numpy()
        assert np.abs(got - want).max() < CORNER_TOL, t
        assert np.isfinite(got).all()


# -- the factory -------------------------------------------------------------

PRESETS = {"ssm_sigma": {0: [0.01] * 8, 1: [0.02] * 8, 2: [0.005] * 8}}
FACTORY_KEYS = (
    ["pf", "pf100", "pf250", "pf500", "pf1k", "pf2k", "pf5k",
     "nn", "nn1k", "nn2k", "nn5k", "nn10k", "nn100k", "gnn", "fgnn",
     "nnkdt", "kdt", "nnkmn", "kmn",
     "pfic", "pffc", "pfes", "nnic", "nnfc", "nnes", "pfrk", "nnrk",
     "pfk", "pfkic", "pfkfc", "pfkes", "nnk", "nnkic", "nnkfc", "nnkes",
     "pfsl3"])


def _same_build(t, j):
    """The port's tracker `t` is built as the JAX package's `j`: the same
    class, members, PF / NN parameters, AM (class and parameters), SSM
    and search-method parameters, recursively."""
    from dataclasses import asdict, fields
    assert type(t).__name__ == type(j).__name__
    for name in ("members",):
        if hasattr(j, name):
            assert len(getattr(t, name)) == len(getattr(j, name))
            for a, b in zip(getattr(t, name), getattr(j, name)):
                _same_build(a, b)
    for name in ("grid_sm", "templ_sm", "sm", "mf"):
        if hasattr(j, name):
            _same_build(getattr(t, name), getattr(j, name))
    for name in ("pf", "nn"):
        if hasattr(j, name):
            assert asdict(getattr(t, name)) == asdict(getattr(j, name))
    if hasattr(j, "am") and hasattr(j, "prm"):
        assert type(t.am).__name__ == type(j.am).__name__
        for f in ("resx", "resy", "n_channels", "likelihood_alpha",
                  "n_bins", "learning_rate"):
            assert getattr(t.am.prm, f) == getattr(j.am.prm, f), f
        assert t.ssm.name == j.ssm.name
        tf = {f.name for f in fields(t.prm)}
        for f in fields(j.prm):
            if f.name in tf:
                assert getattr(t.prm, f.name) == getattr(j.prm, f.name), f


@pytest.mark.parametrize("key", FACTORY_KEYS)
def test_factory_builds_like_jax(key):
    """Every PF and NN key of the JAX factory (the sizes, the exact
    search's FLANN keys, gnn / fgnn, the cascades, the multi-layer
    cascades with their per-layer sigma presets, pfsl3) builds as the JAX
    package builds it."""
    kw = dict(resx=12, resy=12, nn_n_samples=64, nn_ssm_sigma_ids=1,
              pf_ssm_sigma_ids=[0, 2], _presets=PRESETS)
    if key.startswith(("pfk", "nnk")) and key not in ("nnkdt", "nnkmn"):
        kw[f"{key[:2]}k_ssm_sigma_ids"] = [[0], [1], [2]]
        kw[f"{key[:2]}k_n_layers"] = 2
    _same_build(tcreate(key, "ncc", "8", device="cpu", **kw),
                jcreate(key, "ncc", "8", **kw))


@pytest.mark.parametrize("key,kw", [
    ("pfkfc", dict(pf_n_particles=16)),
    ("nnkic", dict(nn_n_samples=24, nnk_n_layers=2)),
    ("pfsl3", dict(pf_n_particles=16, pfsl3_p_x=12, pfsl3_p_y=12)),
    ("nnrk", dict(nn_n_samples=24, crop=96, grid_sub_iters=(1, 2))),
])
def test_stochastic_keys_update(key, kw):
    """A multi-layer PF cascade (coarse-to-fine pixel sigmas), a
    multi-layer NN cascade, pfsl3 (a PF on SL3 with its Karcher mean,
    refined by FCLK) and nnrk (NN, then RKLT) run an update on the CPU
    to finite corners."""
    frame, f2 = _frames()
    sm = tcreate(key, "ssd", "8", device="cpu",
                 **{"resx": 12, "resy": 12, "max_iters": 3, **kw})
    st = sm.update(sm.initialize(frame, OFF_GRID), f2)
    assert torch.isfinite(sm.corners(st)).all()


@pytest.mark.parametrize("key,queue", [
    ("hrch", None), ("hesm", None),
    pytest.param("tld", None, id="tld-Queue 1c"),
    ("regnet", None), ("lp", None)])
def test_factory_rejects_the_rest(key, queue):
    """Of the SM keys slice 9 left, none raises now: hrch, hesm, regnet and
    lp (slice 10) and tld (slice 12, its Median Flow leg checked too;
    the case keeps its id) build as the JAX factory builds them, and so
    do the AMs and the ILM once unported there, and PF's photometric
    sampling (which needs an ILM). The cv2 trackers (ROADMAP Queue 1,
    item 2) are ported too (slice 14), and build as the JAX factory
    builds them."""
    assert type(tcreate("feat", "ssd", "8", device="cpu")).__name__ == \
        type(jcreate("feat", "ssd", "8")).__name__ == "FeatureTracker"
    if queue is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {queue}"):
            tcreate(key, "ssd", "8", device="cpu")
    else:
        _same_build(tcreate(key, "ssd", "8", device="cpu"),
                    jcreate(key, "ssd", "8"))
    for am in ("sad", "scv", "riu", "sum"):
        _same_build(tcreate("pf", am, "8", device="cpu"),
                    jcreate("pf", am, "8"))
    _same_build(tcreate("pf", "ssd", "8", ilm="gb", device="cpu"),
                jcreate("pf", "ssd", "8", ilm="gb"))
    _same_build(tcreate("pf", "ssd", "8", pf_am_sigma=(0.1,), device="cpu"),
                jcreate("pf", "ssd", "8", pf_am_sigma=(0.1,)))


@pytest.mark.parametrize("name", list(LEGS))
def test_convert_round_trip(name):
    """A JAX pffc / nnic init through `convert.to_torch` and back through
    `to_numpy`: every PF / NN leaf as the JAX package laid it out, the
    key replaced by the port's update count."""
    ref = _LEG[name][0].members[0].extra
    key, am, ssm, cfg = LEGS[name]
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    back = convert.to_numpy(convert.to_torch(_LEG[name][0],
                                             device="cpu", sm=sm))
    ex = back.members[0].extra
    assert int(ex.step) == 0
    for field in ex._fields:
        if field in ("step", "key") or getattr(ref, field, None) is None:
            continue
        for a, b in zip(jax.tree.leaves(getattr(ex, field)),
                        jax.tree.leaves(getattr(ref, field))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key,kw", [
    ("pf", dict(pf_n_particles=16, pf_resampling="none")),
    ("gnn", dict(nn_n_samples=24, nn_add_samples_gap=1,
                 nn_n_samples_to_add=4)),
])
def test_donating_fleet_matches(key, kw):
    """A donating fleet (every update written into the state passed in)
    steps as a fleet that allocates new states: also where the PF's new
    `prev_particles` is its old `particles` (no resampling)."""
    frame, f2 = _frames()
    out = []
    for donate in (False, True):
        fl = TrackerFleet(tcreate(key, "ncc", "8", device="cpu",
                                  **{**BASE, **kw}), donate=donate)
        st = fl.initialize(frame, OFF_GRID)
        for f in (f2, frame, f2):
            st = fl.update(st, f)
        out.append(st)
    for a, b in zip(torch.utils._pytree.tree_leaves(out[0]),
                    torch.utils._pytree.tree_leaves(out[1])):
        assert a is b is None or torch.equal(a, b)
