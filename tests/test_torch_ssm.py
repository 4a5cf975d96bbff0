"""Port parity, the SSM surface: every key of the JAX package's
`SSM_REGISTRY` (2-8 DOF) against `mtf_tpu.ssm` on numpy-seeded inputs,
the affine and similitude DLTs, and the factory's coverage of every SSM
key on the chain-kernel trackers (the kernel at S = the SSM's DOF), the
flow grid, RKLT and the sub-tracker grid.

Tolerances, float32 both sides, per family:
  * closed forms (translation to homography, CBH): 1e-5 absolute on
    warps, states and fits (the DLTs solve 3-8 unknown normal equations:
    their rounding is ~1e-6 on these unit-scale points);
  * the Lie SSMs (`l3 l6 l8 sl3`): 1e-4, their `from_matrix` runs 3
    Denman-Beavers square roots and a 12-term log series in float32
    (`logm_3x3`), whose rounding the two packages reach in different
    orders (measured up to 3e-6);
  * generators: 1e-6 (CBH's basis is the Jacobian of its closed form at
    0, by forward-mode autodiff in both packages).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu.ops import warp as jwarp
from mtf_tpu.ops.linalg import inv3x3
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu.ssm.projective import SSM_REGISTRY as JREG
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import warp as twarp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.sm.grid import GridTracker, SubTrackerGrid
from mtf_tpu_torch.ssm import get_ssm as tget_ssm
from mtf_tpu_torch.ssm.base import logm_3x3
from mtf_tpu_torch.ssm.projective import SSM_REGISTRY as TREG
from test_torch_fleet import side_by_side

# one key per class (`test_registry_has_every_key` covers the aliases)
KEYS = ["2", "3s", "3", "l3", "4s", "4", "5", "6", "l6", "8", "l8", "sl3",
        "c8"]
LIE = {"l3", "l6", "l8", "sl3"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU runs beside XLA's thread pool: one PyTorch thread (as the
    other port files do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    """Every key's JAX reference, computed side by side first (each JAX
    SSM built before, one after the other)."""
    for key in KEYS:
        _jssm(key)
    side_by_side([functools.partial(_jax_ref, key) for key in KEYS])


def _tol(key):
    return 1e-4 if key in LIE else 1e-5


def _j(fn, *arrays):
    """Apply a per-sample JAX function over the leading axis."""
    return np.asarray(jax.jit(jax.vmap(fn))(*arrays))


@functools.cache
def _jssm(key):
    """One JAX SSM per key (CBH builds its basis by autodiff)."""
    return jget_ssm(key)


def _case(key, seed=0, b=3, n=12):
    """Two states, source points, the noise that moves their warped
    images to the fits' targets (added inside `_jax_ref`'s one compile),
    and fit weights."""
    rng = np.random.default_rng(seed)
    js = _jssm(key)
    st = rng.normal(0, 0.05, (b, js.dof)).astype(np.float32)
    st2 = rng.normal(0, 0.05, (b, js.dof)).astype(np.float32)
    src = rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32)
    noise = rng.normal(0, 0.01, (b, n, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (b, n)).astype(np.float32)
    return st, st2, src, noise, w


def _lie_fit_matrix(key):
    """The matrix each Lie SSM's `fit_pts` projects through `from_matrix`
    (`mtf_tpu/ssm/projective.py`: LieIsometry the isometry fit, LieAffine
    the affine DLT, LieHomography and SL3 the homography DLT)."""
    if key == "l3":
        iso = jget_ssm("3")
        return lambda s, d, w=None: iso.to_matrix(iso.fit_pts(s, d, w))
    return jwarp.affine_dlt if key == "l6" else jwarp.homography_dlt


@functools.cache
def _jax_ref(key):
    """The inputs and the JAX package's outputs for one SSM, from one
    compiled function. For the Lie SSMs, whose log (3 square roots and a
    12-term series) is slow to compile, compose, invert and fit_pts are
    taken as the JAX methods define them, `from_matrix` of the product,
    the inverse and the fitted matrix, and the log runs once over all of
    them."""
    js = _jssm(key)
    st, st2, src, noise, w = _case(key)
    v = jax.vmap

    @jax.jit
    def run(st, st2, src, noise, w):
        mats = v(js.to_matrix)(st)
        dst = v(js.warp_pts)(st, src) + noise
        if key not in LIE:
            return dict(mats=mats, dst=dst, from_m=v(js.from_matrix)(mats),
                        comp=v(js.compose)(st, st2), inv=v(js.invert)(st),
                        fit=v(js.fit_pts)(src, dst),
                        fit_w=v(js.fit_pts)(src, dst, w))
        fit = _lie_fit_matrix(key)
        prod = jnp.matmul(mats, v(js.to_matrix)(st2),
                          precision=jax.lax.Precision.HIGHEST)
        logs = v(js.from_matrix)(jnp.concatenate([
            mats, prod, v(inv3x3)(mats), v(fit)(src, dst),
            v(fit)(src, dst, w)]))
        from_m, comp, inv, fit_p, fit_w = jnp.split(logs, 5)
        return dict(mats=mats, dst=dst, from_m=from_m, comp=comp, inv=inv,
                    fit=fit_p, fit_w=fit_w)

    out = {k: np.asarray(v) for k, v in run(st, st2, src, noise, w).items()}
    return dict(out, st=st, st2=st2, src=src, w=w,
                gens=np.asarray(js.generators), dof=js.dof)


def test_registry_has_every_key():
    assert set(TREG) == set(JREG)
    for key in KEYS:
        assert TREG[key].__name__ == JREG[key].__name__
        assert TREG[key].dof == JREG[key].dof


@pytest.mark.parametrize("key", KEYS)
def test_ssm_algebra_matches_jax(key):
    """to_matrix, from_matrix, compose, invert and the generators."""
    r = _jax_ref(key)
    ts = tget_ssm(key, device="cpu")
    tol = _tol(key)
    st, st2 = torch.tensor(r["st"]), torch.tensor(r["st2"])
    np.testing.assert_allclose(ts.generators.numpy(), r["gens"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ts.to_matrix(st).numpy(), r["mats"],
                               atol=tol, rtol=0)
    np.testing.assert_allclose(ts.from_matrix(torch.tensor(r["mats"]))
                               .numpy(), r["from_m"], atol=tol, rtol=0)
    np.testing.assert_allclose(ts.compose(st, st2).numpy(), r["comp"],
                               atol=tol, rtol=0)
    np.testing.assert_allclose(ts.invert(st).numpy(), r["inv"], atol=tol,
                               rtol=0)
    # unbatched states go through as the JAX package's do
    np.testing.assert_allclose(ts.to_matrix(st[0]).numpy(), r["mats"][0],
                               atol=tol, rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("key", KEYS)
def test_fit_pts_matches_jax(key, weighted):
    """The closed-form fits (and the DLT dispatch by DOF: homography at 8,
    affine at 5-6, similitude below) with and without weights."""
    r = _jax_ref(key)
    ts = tget_ssm(key, device="cpu")
    args = [torch.tensor(r[k]) for k in ("src", "dst")]
    if weighted:
        args.append(torch.tensor(r["w"]))
    got = ts.fit_pts(*args)
    assert got.shape == (3, r["dof"])
    np.testing.assert_allclose(got.numpy(), r["fit_w" if weighted else "fit"],
                               atol=_tol(key), rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_affine_and_similitude_dlts_match_jax(weighted):
    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (4, 10, 2)).astype(np.float32)
    dst = (src @ rng.normal(0, 0.3, (2, 2)).astype(np.float32)
           + rng.normal(0, 0.5, (4, 1, 2))).astype(np.float32)
    w = rng.uniform(0, 1, (4, 10)).astype(np.float32)
    for jf, tf in ((jwarp.affine_dlt, twarp.affine_dlt),
                   (jwarp.similitude_dlt, twarp.similitude_dlt)):
        args = (src, dst, w) if weighted else (src, dst)
        got = tf(*(torch.tensor(a) for a in args)).numpy()
        np.testing.assert_allclose(got, _j(jf, *args), atol=1e-5, rtol=0)


def test_logm_inverts_matrix_exp_in_float32():
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.normal(0, 0.05, (5, 3, 3)), dtype=torch.float32)
    np.testing.assert_allclose(logm_3x3(torch.linalg.matrix_exp(X)).numpy(),
                               X.numpy(), atol=1e-5, rtol=0)


def test_get_ssm_rejects_the_spline_ssms():
    """The spline SSMs are ported (`test_torch_spline.py` holds them
    against the JAX package): the keys build the JAX package's 50- and
    32-DOF SSMs; an unknown key raises."""
    for key, dof in (("spline", 50), ("spl", 50), ("tps", 32)):
        t, j = tget_ssm(key, device="cpu"), jget_ssm(key)
        assert (t.name, t.dof) == (j.name, j.dof) and t.dof == dof
    with pytest.raises(ValueError, match="unknown SSM"):
        tget_ssm("nope", device="cpu")


# -- factory coverage --------------------------------------------------------
SMALL = dict(resx=12, resy=12, max_iters=3, epsilon=0.0, interp="linear_mm",
             crop=48, coarse_pt_iters=((2, 1),))


def _scene(h=96, w=112):
    rng = np.random.default_rng(4)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


CORNERS = np.array([[[30, 28], [62, 30], [60, 60], [31, 58]]], np.float32)


@pytest.mark.parametrize("key", KEYS)
def test_every_lk_key_runs_on_every_ssm(key, monkeypatch):
    """fclk, esm, fclm and eslm on ssd and ncc build and update for every
    SSM key, each iteration one chain-kernel call at S = the SSM's DOF."""
    frame = _scene()
    f2 = np.roll(frame, (1, 1), (0, 1))
    calls = []
    real = tk.lk_fused_chain_raw

    def spy(window, M0, gens, *a, **kw):
        calls.append(gens.shape[0])
        return real(window, M0, gens, *a, **kw)

    monkeypatch.setattr(tk, "lk_fused_chain_raw", spy)
    for sm in ("fclk", "esm", "fclm", "eslm"):
        for am in ("ssd", "ncc"):
            calls.clear()
            trk = tcreate(sm, am, key, device="cpu", **SMALL)
            st = trk.update(trk.initialize(frame, CORNERS), f2)
            assert calls == [trk.ssm.dof] * 3, (sm, am)
            assert bool(torch.isfinite(trk.corners(st)).all()), (sm, am)


@pytest.mark.parametrize("key", ["2", "4", "6", "8"])
def test_grid_and_rklt_run_on_low_dof_ssms(key):
    frame = _scene()
    f2 = np.roll(frame, (1, 1), (0, 1))
    cfg = dict(SMALL, grid_res=4, grid_patch_res=4, grid_sub_iters=(1, 2),
               grid_coarse_stride=2, crop=64)
    for sm in ("grid", "rklt"):
        trk = tcreate(sm, "ssd", key, device="cpu", **cfg)
        st = trk.update(trk.initialize(frame, CORNERS), f2)
        assert bool(torch.isfinite(trk.corners(st)).all()), sm
        assert trk.ssm.dof == tget_ssm(key, device="cpu").dof


def test_grid_sm_builds_the_sub_tracker_grid():
    trk = tcreate("grid", "ssd", "8", device="cpu", grid_sm="fclk",
                  **dict(SMALL, grid_res=3))
    assert isinstance(trk, SubTrackerGrid)
    assert trk.sub.name == "fclk" and trk.sub.ssm.name == "trans"
    assert trk.sub.am.prm.resx == trk.sub.am.prm.resy == 8
    assert trk.sub.prm.crop == SMALL["crop"]
    frame = _scene()
    st = trk.update(trk.initialize(frame, CORNERS),
                    np.roll(frame, (1, 1), (0, 1)))
    assert st.extra.sub_states.ssm_state.shape == (9, 2)
    assert bool(torch.isfinite(trk.corners(st)).all())
    assert isinstance(tcreate("grid", "ssd", "8", device="cpu",
                              grid_sm="flow", **SMALL), GridTracker)
    # without a crop (as the JAX factory builds it) the sub-trackers read
    # the whole frame
    trk = tcreate("grid", "ssd", "8", device="cpu", grid_sm="esm",
                  **dict(SMALL, grid_res=3, crop=None))
    assert isinstance(trk, SubTrackerGrid) and trk.sub.prm.crop is None
    st = trk.update(trk.initialize(frame, CORNERS),
                    np.roll(frame, (1, 1), (0, 1)))
    assert bool(torch.isfinite(trk.corners(st)).all())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_chain_kernel_rejects_other_state_sizes(device):
    """S outside {2, 3, 4, 5, 6, 8} raises ValueError on every device,
    before anything runs."""
    win = torch.zeros(1, 32, 32, device=device)
    for s in (1, 7, 9):
        with pytest.raises(ValueError, match=f"S = {s}"):
            tk.lk_fused_chain(win, torch.zeros(1, 3, 3, device=device),
                              torch.zeros(s, 3, 3, device=device),
                              torch.zeros(1, 3, 4, device=device),
                              torch.zeros(1, 4, device=device))
    with pytest.raises(ValueError, match="S = 7"):
        tk.lk_fused_gn_t(win, torch.zeros(1, 2, 4, device=device),
                         torch.zeros(1, 14, 4, device=device),
                         torch.zeros(1, 4, device=device))
