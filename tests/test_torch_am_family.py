"""Port parity, slice 10's appearance side: NSSD, ZNCC, SAD, the SCV
family, RIU, NGF, PCA, DFM and the sum of AMs (`mtf_tpu_torch/am/`), the
illumination models GB, PGB and RBF (`am/ilm.py`) on the LK path and in
the particle filter's photometric sampling, the hierarchical search
methods and the line tracker, against the JAX package on the same inputs.

AMs on 16x16 patches of C = 1 and 3 channels: f within 1e-5 of its
scale, df/dIt, df/dI0 (through `init`) and the Gauss-Newton Hessian
within 1e-4 of their norm, likelihood and distance features within 1e-5.
Tracker legs start from the JAX init (`convert.to_torch`) with the
corners off the pixel grid (ROADMAP Queue 3, item 2) and hold every frame
within 0.05 px (a grid update within 0.1 px, on the JAX RANSAC draw; PF
on the JAX draws). The JAX references are computed side by side
(`test_torch_fleet.side_by_side`), most of them in one jit each.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.am import get_am as jget_am
from mtf_tpu.am.base import AMParams as JAMParams
from mtf_tpu.am.base import gn_hessian as jgn_hessian
from mtf_tpu.am.ilm import ILM_REGISTRY as JILM
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.am import AMParams, get_am, get_ilm, gn_hessian
from mtf_tpu_torch.parallel import TrackerFleet
from test_torch_fleet import CORNERS, _scene, side_by_side
from test_torch_grid import jax_fit_indices, use_indices
from test_torch_pf_nn import _same_build

REL = 1e-4          # gradients and Hessians, of their norm
VAL_REL = 1e-5      # similarities, likelihoods, features
CORNER_TOL = 0.05
GRID_TOL_PX = 0.1
RES = 16
S = 4
OFF_GRID = (CORNERS[:2] + np.float32([0.31, 0.27])).astype(np.float32)
SHIFT = (1, 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this module, beside XLA's compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the AMs ------------------------------------------------------------------

AMS = ("nssd", "zncc", "sad", "scv", "rscv", "lscv", "lrscv", "riu", "ngf",
       "pca", "dfm")
SUMS = (("ssd", "ncc"), ("zncc", "scv"))
AM_CASES = ([(k, c) for k in AMS for c in (1, 3)]
            + [(f"sum:{a}+{b}", 1) for a, b in SUMS])


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed + c)
    n = RES * RES
    templ = rng.uniform(0, 255, (n, c)).astype(np.float32)
    patch = np.clip(templ + rng.normal(0, 12, templ.shape), 0, 255).astype(
        np.float32)
    J = rng.normal(0, 1, (n * c, S)).astype(np.float32)
    return templ, patch, J


def _params(key):
    # 3 patches centred span 2 dimensions: a third basis vector would be
    # any unit vector of the null space, so the basis keeps 2
    extra = {"n_eigenvec": 2, "batch_size": 3}
    if key.startswith("sum:"):
        a, b = key[4:].split("+")
        extra.update(sum_am1=a, sum_am2=b)
    return dict(resx=RES, resy=RES, likelihood_alpha=0.5, extra=extra)


def _am_key(key, c):
    k = "sum" if key.startswith("sum:") else key
    return k if c == 1 else "mc" + k


def _jam(key, c, ilm=None):
    return jget_am(_am_key(key, c), replace(JAMParams(), **_params(key)),
                   ilm=ilm)


def _tam(key, c, ilm=None):
    return get_am(_am_key(key, c), AMParams(**_params(key)), ilm=ilm)


def _pca_refit_patches():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 255, (4, RES * RES, 1)).astype(np.float32)


ILM_KEYS = ("gb", "pgb", "rbf")


def _ilm_inputs():
    """{key: (patches (3, N, 2), parameters (3, P))}."""
    rng = np.random.default_rng(3)
    out = {}
    for key in ILM_KEYS:
        n_p = {"gb": 2}.get(key, 10)
        out[key] = (rng.uniform(0, 255, (3, RES * RES, 2)).astype(np.float32),
                    rng.normal(0, 0.1, (3, n_p)).astype(np.float32))
    return out


@functools.cache
def _refs():
    """{case: the JAX AM's f, grad, grad_template, Gauss-Newton Hessian,
    likelihood and distance features}, PCA across a refit (`batch_size`
    3: mean, projector B B^T, f and grad after four updates), and each
    ILM's `apply` and its Jacobian in the parameters, in one jit."""
    jams = [_jam(*case) for case in AM_CASES]
    ins = [_inputs(c) for _, c in AM_CASES]
    jpca = _jam("pca", 1)
    jilms = {k: JILM[k](RES, RES) if k != "gb" else JILM[k]()
             for k in ILM_KEYS}

    def run(ins, upd, ilm_ins):
        out = []
        for jam, (t, p, J) in zip(jams, ins):
            st = jam.init(t)
            out.append([jam.f(st, p), jam.grad(st, p),
                        jam.grad_template(st, p), jgn_hessian(jam, st, p, J),
                        jam.likelihood(st, p), jam.dist_feat(p)])
        t, p, _ = ins[AM_CASES.index(("pca", 1))]
        st = jpca.init(t)
        for u in upd:
            st = jpca.update_model(st, u)
        mean, basis = st.extra[0], st.extra[1]
        pca = [mean, basis @ basis.T, jpca.f(st, p), jpca.grad(st, p),
               st.extra[3]]
        ilm = {k: (jax.vmap(jilms[k].apply)(*ilm_ins[k]),
                   jax.jacfwd(jilms[k].apply, argnums=1)(ilm_ins[k][0][0],
                                                         ilm_ins[k][1][0]))
               for k in ILM_KEYS}
        return out, pca, ilm
    out, pca, ilm = jax.jit(run)(ins, _pca_refit_patches(), _ilm_inputs())
    refs = {case: [np.asarray(x) for x in o]
            for case, o in zip(AM_CASES, out)}
    refs["pca_refit"] = [np.asarray(x) for x in pca]
    refs["ilm"] = {k: [np.asarray(x) for x in v] for k, v in ilm.items()}
    return refs


@pytest.mark.parametrize("key,c", AM_CASES)
def test_am_matches_jax(key, c):
    """f, df/dIt, df/dI0 (through `init`) and the Gauss-Newton Hessian at
    the patch; the likelihood and the NN distance features."""
    tam = _tam(key, c)
    templ, patch, J = (torch.tensor(x)[None] for x in _inputs(c))
    st = tam.init(templ)
    want = _refs()[(key, c)]
    f = float(tam.f(st, patch)[0])
    assert abs(f - float(want[0])) <= VAL_REL * abs(float(want[0])) + 1e-6
    got = [tam.grad(st, patch), tam.grad_template(st, patch),
           gn_hessian(tam, st, patch, J)]
    for name, g, w in zip(("grad", "grad_template", "gn_hessian"), got,
                          want[1:4]):
        assert _rel(g[0].numpy(), w) < REL, name
    assert _rel(tam.likelihood(st, patch)[0].numpy(), want[4]) < VAL_REL
    assert _rel(tam.dist_feat(patch)[0].numpy(), want[5]) < VAL_REL


def test_pca_refit_matches_jax():
    """PCA across a refit (`batch_size` 3, four updates): the ring
    buffer's count, the mean and the subspace (its projector B B^T: the
    basis' signs are the SVD's own and f does not depend on them), f and
    df/dIt after it."""
    tam = _tam("pca", 1)
    templ, patch, _ = (torch.tensor(x)[None] for x in _inputs(1))
    st = tam.init(templ)
    for u in _pca_refit_patches():
        st = tam.update_model(st, torch.tensor(u)[None])
    mean, basis, _, count = st.extra
    want = _refs()["pca_refit"]
    assert int(count[0]) == int(want[4]) == 4
    assert _rel(mean[0].numpy(), want[0]) < VAL_REL
    assert _rel((basis[0] @ basis[0].T).numpy(), want[1]) < REL
    assert abs(float(tam.f(st, patch)[0]) - float(want[2])) \
        <= REL * abs(float(want[2]))
    assert _rel(tam.grad(st, patch)[0].numpy(), want[3]) < REL


def test_scv_remap_is_constant_under_func_transforms():
    """SCV's remap table is held constant (`.detach()`, the JAX package's
    `stop_gradient`) under `torch.func.jvp` in a `vmap`, as in
    `gn_hessian`: the Hessian-vector product through the table's inputs
    is SSD's in bin coordinates, so a column of J gives -J scaled by the
    bin slope squared (SCV's table does not depend on the candidate)."""
    tam = _tam("scv", 1)
    templ, patch, _ = (torch.tensor(x)[None] for x in _inputs(1))
    st = tam.init(templ)
    v = torch.randn(2, 1, RES * RES)
    g = lambda p: tam.grad(st, p.reshape(patch.shape)).flatten(1)  # noqa
    cols = torch.func.vmap(lambda t: torch.func.jvp(
        g, (patch.flatten(1),), (t,))[1])(v)
    z = (tam.prm.n_bins - 1.0 - 2 * tam.prm.pre_seed) / 255.0
    torch.testing.assert_close(cols, -z * z * v, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("key", ILM_KEYS)
def test_ilm_apply_matches_jax(key):
    """The ILM's `apply` at random parameters, on a batch of three and on
    one tracker, and its Jacobian in the parameters (the LK path's
    photometric columns; an LK leg with PGB is below)."""
    patch, p = (torch.tensor(x) for x in _ilm_inputs()[key])
    want, jw = _refs()["ilm"][key]
    t = get_ilm(key, AMParams(resx=RES, resy=RES))
    assert t.n_params == p.shape[-1]
    assert _rel(t.apply(patch, p).numpy(), want) < VAL_REL
    assert _rel(t.apply(patch[0], p[0]).numpy(), want[0]) < VAL_REL
    jg = torch.func.jacfwd(t.apply, argnums=1)(patch[0], p[0])
    assert _rel(jg.numpy(), jw) < VAL_REL


def test_full_grid_ams_raise_under_coarse_phases():
    """NGF, LSCV, LRSCV and DFM need the (resy, resx) grid; a coarse phase
    samples a decimated one, so both packages raise at init (as for
    LKLD)."""
    cfg = dict(resx=RES, resy=RES, max_iters=2, interp="linear_mm",
               crop=64, coarse_pt_iters=((2, 1),))
    frame = _scene()
    # the JAX package's shape error, once: the four fail alike (a reshape
    # of the decimated points to the full grid)
    with pytest.raises(Exception):
        jax.eval_shape(jcreate("fclk", "ngf", "8", **cfg).initialize,
                       frame, OFF_GRID[0])
    for am in ("ngf", "lscv", "lrscv", "dfm"):
        with pytest.raises(RuntimeError):
            tcreate("fclk", am, "8", device="cpu", **cfg).initialize(
                frame, OFF_GRID)


# -- trackers: short legs from the JAX init -----------------------------------

LEG_CFG = dict(resx=RES, resy=RES, max_iters=5, epsilon=0.0,
               interp="linear_mm", crop=144, coarse_pt_iters=((2, 2),))
LEGS = {
    # ESM on the translation, then on the homography: the chain kernel's
    # ssd_esm mode at S = 2, then 8 (its plain form here)
    "hesm_ssd": ("hesm", "ssd", "8", None, LEG_CFG),
    "esm_rscv": ("esm", "rscv", "8", None, LEG_CFG),
    # an ILM: the generic path's joint solve over S + P = 18 columns
    "fclk_ssd_pgb": ("fclk", "ssd", "8", "pgb", LEG_CFG),
}
# one FCLK update with GB and with RBF (the generic path's joint solve
# over S + 2 and S + 10 columns), one PF update with GB's
# photometric random walk on the JAX draws, and one line-tracker update
ONE_UPDATE = {
    "fclk_ssd_gb": ("fclk", "ssd", "8", "gb", LEG_CFG),
    "fclk_ssd_rbf": ("fclk", "ssd", "8", "rbf", LEG_CFG),
    "pf_ssd_gb": ("pf", "ssd", "8", "gb", dict(
        resx=RES, resy=RES, interp="linear_mm", crop=96, pf_n_particles=48,
        pf_am_sigma=(0.02, 2.0))),
    # the line tracker on the rklt row's grid options
    "line_ssd": ("line", "ssd", "8", None, dict(
        resx=RES, resy=RES, interp="linear_mm", crop=96,
        grid_sub_iters=(1, 8), grid_coarse_stride=2)),
}
_REF = {}


@functools.cache
def _leg_frames():
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth
    frames, gt = synth.synthetic_sequence(
        _scene(), OFF_GRID, get_ssm("8", device="cpu"), n_frames=5,
        sigma_scale=0.004, seed=3)
    return frames.numpy()


def jax_run(sm, frames, corners):
    """The JAX tracker `sm`'s init on frames[0] and updates on the others,
    one tracker at a time through one jit of each (a fleet is the vmap
    of these; tracing the vmap costs more than the runs): [the stacked
    init state, then (corners (B, 2, 4), the stacked state) per update],
    in numpy."""
    def stack(states):
        return jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]),
                            *states)
    init, upd = jax.jit(sm.initialize), jax.jit(sm.update)
    sts = [init(frames[0], c) for c in corners]
    out = [stack(sts)]
    for t in range(1, len(frames)):
        sts = [upd(s, frames[t]) for s in sts]
        out.append((np.stack([np.asarray(sm.corners(s)) for s in sts]),
                    stack(sts)))
    return out


def _jax_run(name, frames):
    key, am, ssm, ilm, cfg = {**LEGS, **ONE_UPDATE}[name]
    _REF[name] = jax_run(jcreate(key, am, ssm, ilm, **cfg), frames,
                         OFF_GRID)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    """Every JAX reference of the module, side by side."""
    frames = _leg_frames()
    two = np.stack([frames[0], np.roll(frames[0], SHIFT, (0, 1))])
    side_by_side([_refs] + [functools.partial(_jax_run, n, frames)
                            for n in LEGS]
                 + [functools.partial(_jax_run, n, two) for n in ONE_UPDATE])


def _port(name):
    key, am, ssm, ilm, cfg = {**LEGS, **ONE_UPDATE}[name]
    return tcreate(key, am, ssm, ilm, device="cpu", **cfg)


@pytest.mark.parametrize("name", list(LEGS))
def test_leg_matches_jax(name):
    """hesm/ssd/8, esm/rscv/8 and fclk/ssd/8 with PGB over a 4-frame
    synthetic leg by a donating fleet from the JAX init: the corners
    within 0.05 px of the JAX package's on every frame (and PGB's
    photometric parameters with them)."""
    ref = _REF[name]
    sm = _port(name)
    fl = TrackerFleet(sm, donate=True)
    st = convert.to_torch(ref[0], device="cpu", sm=sm)
    frames = _leg_frames()
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        want, jst = ref[t]
        got = fl.corners(st).numpy()
        assert np.abs(got - want).max() < CORNER_TOL, t
        if name == "fclk_ssd_pgb":
            p = st.am_state.p_am.numpy()
            assert np.abs(p - jst.am_state.p_am).max() \
                < 1e-2 * max(1.0, np.abs(jst.am_state.p_am).max()), t


def _one_update(name):
    ref = _REF[name]
    sm = _port(name)
    frame2 = np.roll(_leg_frames()[0], SHIFT, (0, 1))
    st = convert.to_torch(ref[0], device="cpu", sm=sm)
    return sm, ref, st, frame2


@pytest.mark.parametrize("name", ["fclk_ssd_gb", "fclk_ssd_rbf"])
def test_ilm_update_matches_jax(name):
    """One FCLK update of fclk/ssd/8 with GB and with RBF from the JAX
    init: the corners within 0.05 px of the JAX package's, the
    photometric parameters as PGB's leg holds them."""
    sm, ref, st, frame2 = _one_update(name)
    out = TrackerFleet(sm).update(st, frame2)
    want, jst = ref[1]
    assert np.abs(sm.corners(out).numpy() - want).max() < CORNER_TOL
    p, jp = out.am_state.p_am.numpy(), jst.am_state.p_am
    assert p.shape == jp.shape and p.shape[-1] == sm.am.ilm.n_params > 0
    assert np.abs(p - jp).max() < 1e-2 * max(1.0, np.abs(jp).max())


@functools.cache
def _pf_am_draws(seed, P, S, A):
    """The JAX PF's first update's draws with its photometric walk's
    normals from `k_am` (`mtf_tpu/sm/pf.py:476-484`)."""
    from mtf_tpu_torch.sm.pf import PFDraw
    key = jax.random.PRNGKey(seed)
    key, k_prop, k_res, k_distr, k_am = jax.random.split(key, 5)
    prop = jax.vmap(lambda k: jax.random.normal(k, (S,), jnp.float32))(
        jax.random.split(k_prop, P))
    return PFDraw(*(torch.tensor(np.asarray(x)) for x in (
        prop, jax.random.gumbel(k_distr, (P, 1), jnp.float32),
        jax.random.uniform(k_res, ()),
        jax.random.normal(k_am, (P, A), jnp.float32))))


def test_pf_photometric_walk_matches_jax():
    """PF with GB and `pf_am_sigma` on the JAX draws: the photometric
    particles and their weighted mean (the tracker's p_am), the particles,
    the log-weights and the corners."""
    sm, ref, st, frame2 = _one_update("pf_ssd_gb")
    pf = sm
    d = _pf_am_draws(0, pf.pf.n_particles, pf.ssm.dof, pf.am.ilm.n_params)
    pf._draw = lambda step: d
    out = sm.update(st, frame2)
    want, jst = ref[1]
    ex, jex = out.extra, jst.extra
    assert ex.am_particles.shape == (2, 48, 2)
    np.testing.assert_allclose(ex.am_particles.numpy(), jex.am_particles,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.am_state.p_am.numpy(),
                               jst.am_state.p_am, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ex.particles.numpy(), jex.particles,
                               rtol=1e-5, atol=1e-6)
    lw, jlw = ex.log_weights.numpy(), jex.log_weights
    assert (np.abs(lw - jlw) <= 1e-4 * np.maximum(1.0, np.abs(jlw))).all()
    assert np.abs(sm.corners(out).numpy() - want).max() < CORNER_TOL


def test_pf_am_sigma_without_ilm_is_ignored():
    """Without an ILM (or one without parameters) `pf_am_sigma` is ignored,
    as in the JAX package: no photometric particles."""
    sm = tcreate("pf", "ssd", "8", device="cpu", pf_am_sigma=(0.1,),
                 resx=RES, resy=RES, pf_n_particles=8)
    st = sm.initialize(_scene(), OFF_GRID)
    assert st.extra.am_particles.shape == (2, 8, 0)


def test_line_update_matches_jax():
    """One line-tracker update on the JAX package's RANSAC draw: the
    line-snapped fit within 0.1 px (the grid's tolerance) and the same
    inlier weights."""
    sm, ref, st, frame2 = _one_update("line_ssd")
    use_indices(sm, jax_fit_indices(1))
    out = sm.update(st, frame2)
    want, jst = ref[1]
    assert np.abs(sm.corners(out).numpy() - want).max() < GRID_TOL_PX
    np.testing.assert_array_equal(out.extra.inlier_mask.numpy(),
                                  jst.extra.inlier_mask)


# -- the factory and convert --------------------------------------------------

FACTORY_CASES = (
    [("fclk", am, "8", None, {}) for am in AMS]
    + [("fclk", "mc" + am, "8", None, {}) for am in AMS]
    + [("fclk", am + "3", "8", None, {}) for am in ("zncc", "scv")]
    + [("fclk", "sum", "8", None, {}),
       ("fclk", "sum", "8", None, dict(sum_am1="zncc", sum_am2="scv")),
       ("fclk", "ngf", "8", None, dict(am_extra={"eta": 2.0})),
       ("pf", "ssd", "8", "gb", dict(pf_am_sigma=(0.1, 1.0)))]
    + [("fclk", "ssd", "8", ilm, {}) for ilm in ILM_KEYS]
    + [(k, "ssd", "8", None, {}) for k in ("hrch", "hesm", "line")]
    + [("hrch", "ncc", "6", None, dict(hrch_sm="fclk", hrch_ssm="3s"))])


@pytest.mark.parametrize("key,am,ssm,ilm,kw", FACTORY_CASES)
def test_factory_builds_like_jax(key, am, ssm, ilm, kw):
    """Every new AM key (with its `mc*` / `*3` forms), the sum of AMs and
    its sub-AM options, `am_extra`, each ILM, and the hierarchical and
    line keys build as the JAX factory builds them: the same classes, AM
    parameters and extras, ILM and its parameter count."""
    t = tcreate(key, am, ssm, ilm, device="cpu", **kw)
    j = jcreate(key, am, ssm, ilm, **kw)
    _same_build(t, j)
    for a, b in zip([m for m in t.modules() if hasattr(m, "am")],
                    [j] if not hasattr(j, "members") else j.members):
        assert type(a.am.ilm).__name__ == type(b.am.ilm).__name__
        assert a.am.ilm.n_params == b.am.ilm.n_params
        assert a.am.prm.extra == b.am.prm.extra
        assert a.am.name == b.am.name
    if key in ("hrch", "hesm"):
        assert [m.ssm.name for m in t.members] == \
            [m.ssm.name for m in j.members]


@pytest.mark.parametrize("name", list(LEGS) + ["pf_ssd_gb", "line_ssd"])
def test_convert_round_trip(name):
    """A JAX init through `convert.to_torch` and back through `to_numpy`:
    every leaf as the JAX package laid it out (p_am of an ILM, the PF's
    photometric particles, the line tracker's grid)."""
    ref = _REF[name][0]
    sm = _port(name)
    back = convert.to_numpy(convert.to_torch(ref, device="cpu", sm=sm))
    want = jax.tree.leaves(ref, is_leaf=lambda x: x is None)
    got = jax.tree.leaves(back, is_leaf=lambda x: x is None)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a is None or np.ndim(b) == 1 and np.asarray(b).dtype == np.uint32:
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
