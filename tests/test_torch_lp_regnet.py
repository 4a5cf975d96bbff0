"""Port parity, slice 10's learned search methods: the linear predictor
(`mtf_tpu_torch/sm/lp.py`) and RegNet (`sm/regnet.py`) against the JAX
package's (`mtf_tpu/sm/lp.py`, `sm/regnet.py`), with the factory keys
that build them.

Their draws are their own; here both are handed the JAX package's
(`jax_lp_draws`: `split(PRNGKey(seed), n_stages)`, `lp.py:124-126`;
`jax_regnet_draw`: the key chain of `regnet.py:97-140`) and start from the
JAX init (`convert.to_torch`). 16x16 templates, B = 2, on the test scene
with the corners off the pixel grid (ROADMAP Queue 3, item 2).

Tolerances: the LP predictors within 1e-3 of their norm (a ridge solve
of the K x K Gram matrix in float32), RegNet's weights after 20 Adam
steps within 1e-4 of their norm, corners within 0.05 px.
"""
import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm.lp import LP
from mtf_tpu_torch.sm.regnet import RegNet, RegNetDraw, adam_step
from test_torch_am_family import jax_run
from test_torch_fleet import CORNERS, _scene, side_by_side
from test_torch_pf_nn import _same_build

CORNER_TOL = 0.05
OFF_GRID = (CORNERS[:2] + np.float32([0.31, 0.27])).astype(np.float32)
BASE = dict(resx=16, resy=16, interp="linear_mm", crop=144)
LPFC = ("lpfc", "ssd", "8", dict(BASE, max_iters=5, epsilon=0.0,
                                 lp_n_samples=64, lp_n_stages=2,
                                 coarse_pt_iters=((2, 2),)))
REGNET = ("regnet", "ssd", "2", dict(BASE, interp="linear",
                                     rg_n_samples=96, rg_hidden=(16, 8),
                                     rg_train_steps=20, rg_pix_sigma=3.0))


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


# -- the JAX package's draws --------------------------------------------------

@functools.cache
def jax_lp_draws(seed, n_stages, K, S):
    """Each LP stage's (K, S) normals from `split(PRNGKey(seed),
    n_stages)`."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_stages)
    return [torch.tensor(np.asarray(jax.random.normal(k, (K, S),
                                                      jnp.float32)))
            for k in keys]


@functools.cache
def jax_regnet_draw(seed, K, S, sizes, steps, batch):
    """RegNet's training draws: the perturbations' normals (`k_dp`), each
    layer's normal / sqrt(fan-in) initial weights (`_mlp_init`) and each
    step's minibatch indices (`split(key, train_steps)`, `randint`)."""
    key = jax.random.PRNGKey(seed)
    key, k_dp = jax.random.split(key)
    dps = jax.random.normal(k_dp, (K, S), jnp.float32)
    k, weights = key, []
    for a, b in zip(sizes[:-1], sizes[1:]):
        k, kw = jax.random.split(k)
        weights.append(torch.tensor(np.asarray(
            jax.random.normal(kw, (a, b), jnp.float32)
            / jnp.sqrt(jnp.asarray(a, jnp.float32)))))
    idx = jnp.stack([jax.random.randint(kk, (batch,), 0, K)
                     for kk in jax.random.split(key, steps)])
    return RegNetDraw(torch.tensor(np.asarray(dps)), tuple(weights),
                      torch.tensor(np.asarray(idx), dtype=torch.int64))


def inject(sm):
    """Hand every LP and RegNet of `sm` the JAX package's draws."""
    for m in sm.modules():
        if isinstance(m, LP):
            d = jax_lp_draws(m.lp.seed, m.lp.n_stages, m.lp.n_samples,
                             m.ssm.dof)
            m._draw = lambda stage, d=d: d[stage]
        elif isinstance(m, RegNet):
            rn = m.rn
            m._draw = (lambda sizes, rn=rn, S=m.ssm.dof: jax_regnet_draw(
                rn.seed, rn.n_samples, S, tuple(sizes), rn.train_steps,
                rn.batch_size))
    return sm


# -- the JAX references -------------------------------------------------------

_REF = {}


@functools.cache
def _leg_frames():
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth
    frames, _ = synth.synthetic_sequence(
        _scene(), OFF_GRID, get_ssm("8", device="cpu"), n_frames=5,
        sigma_scale=0.004, seed=3)
    return frames.numpy()


def _jax_run(name, spec, frames):
    key, am, ssm, cfg = spec
    out = jax_run(jcreate(key, am, ssm, **cfg), frames, OFF_GRID)
    _REF[name] = [out[0]] + [c for c, _ in out[1:]]


def _jax_adam():
    """optax.adam's 20 steps on a fixed quadratic of two (W, b) pairs."""
    import optax
    rng = np.random.default_rng(2)
    params = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32))
              for s in ((5, 4), (4,), (4, 3), (3,))]
    target = [jnp.asarray(rng.normal(0, 1, p.shape).astype(np.float32))
              for p in params]
    opt = optax.adam(1e-2)
    st = opt.init(params)
    loss = lambda p: sum(jnp.sum((a - b) ** 2 * (1 + a * a))  # noqa: E731
                         for a, b in zip(p, target))
    out = params
    for _ in range(20):
        g = jax.grad(loss)(out)
        u, st = opt.update(g, st, out)
        out = optax.apply_updates(out, u)
    _REF["adam"] = ([np.asarray(p) for p in params],
                    [np.asarray(t) for t in target],
                    [np.asarray(p) for p in out])


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    frames = _leg_frames()
    two = np.stack([frames[0], np.roll(frames[0], (1, 2), (0, 1))])
    side_by_side([functools.partial(_jax_run, "lpfc", LPFC, frames),
                  functools.partial(_jax_run, "regnet", REGNET, two),
                  _jax_adam])


def _port(spec):
    key, am, ssm, cfg = spec
    return inject(tcreate(key, am, ssm, device="cpu", **cfg))


# -- LP -----------------------------------------------------------------------

def test_lp_predictors_match_jax():
    """lpfc's LP stage (on the 2-DOF SSM: the tracker's has 8) trained on
    the JAX draws: each stage's (S, N) predictor within 1e-3 of its norm,
    the template patch within 1e-5."""
    sm = _port(LPFC)
    st = sm.initialize(_leg_frames()[0], OFF_GRID)
    ls, jls = st.members[0].extra, _REF["lpfc"][0].members[0].extra
    assert sm.members[0].ssm.dof == 2
    assert ls.A.shape == jls.A.shape
    for i in range(ls.A.shape[1]):
        assert _rel(ls.A[:, i].numpy(), jls.A[:, i]) < 1e-3, i
    assert _rel(ls.patch0.numpy(), jls.patch0) < 1e-5


def test_lpfc_leg_matches_jax():
    """lpfc/ssd/8 over a 4-frame synthetic leg from the JAX init: the LP
    stage's predictions and FCLK's refinement within 0.05 px of the JAX
    package's on every frame."""
    sm = _port(LPFC)
    fl = TrackerFleet(sm, donate=True)
    st = convert.to_torch(_REF["lpfc"][0], device="cpu", sm=sm)
    frames = _leg_frames()
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - _REF["lpfc"][t]).max() < CORNER_TOL, t


# -- RegNet -------------------------------------------------------------------

def test_adam_matches_optax():
    """`adam_step` against optax.adam over 20 steps of the same gradients
    (a fixed non-quadratic loss): within 1e-5 of the weights' norm."""
    p0, target, want = _REF["adam"]
    params = tuple(torch.tensor(p) for p in p0)
    tgt = [torch.tensor(t) for t in target]
    mu = tuple(torch.zeros_like(p) for p in params)
    nu = tuple(torch.zeros_like(p) for p in params)
    loss = lambda p: sum(((a - b) ** 2 * (1 + a * a)).sum()  # noqa: E731
                         for a, b in zip(p, tgt))
    for t in range(20):
        params, mu, nu = adam_step(params, torch.func.grad(loss)(params),
                                   mu, nu, t + 1, 1e-2)
    for g, w in zip(params, want):
        assert _rel(g.numpy(), w) < 1e-5


def test_regnet_training_matches_jax():
    """RegNet trained on the JAX draws (96 samples, hidden 16-8, 20 Adam
    steps): every layer's weights and biases within 1e-4 of their norm,
    the template features and their scale within 1e-5."""
    sm = _port(REGNET)
    st = sm.initialize(_leg_frames()[0], OFF_GRID)
    rs, jrs = st.extra, _REF["regnet"][0].extra
    for (w, b), (jw, jb) in zip(rs.params, jrs.params):
        assert _rel(w.numpy(), jw) < 1e-4
        assert _rel(b.numpy(), jb) < 1e-4
    assert _rel(rs.feat0.numpy(), jrs.feat0) < 1e-5
    assert _rel(rs.feat_scale.numpy(), jrs.feat_scale) < 1e-5


def test_regnet_update_matches_jax():
    """One RegNet update from the JAX state: within 0.05 px."""
    sm = _port(REGNET)
    st = convert.to_torch(_REF["regnet"][0], device="cpu", sm=sm)
    out = sm.update(st, np.roll(_leg_frames()[0], (1, 2), (0, 1)))
    assert np.abs(sm.corners(out).numpy() - _REF["regnet"][1]).max() \
        < CORNER_TOL


# -- the factory and convert --------------------------------------------------

FACTORY = [("lp", "ssd", "8", {}), ("lp", "ssd", "4", {}),
           ("lpfc", "ssd", "8", {}), ("lpic", "ncc", "6", {}),
           ("lpes", "ssd", "4", {}), ("lpfc", "ssd", "8", dict(lp_ssm="4")),
           ("lp", "ssd", "8", dict(lp_n_samples=32, lp_max_iters=2,
                                   lp_pix_sigma=2.0, lp_ridge=0.1,
                                   lp_n_stages=2, lp_epsilon=0.1, seed=3)),
           ("regnet", "ssd", "8", {}), ("regnet", "zncc", "2", dict(
               rg_n_samples=64, rg_hidden=(8,), rg_train_steps=5,
               rg_max_iters=2, rg_pix_sigma=2.0, seed=1)),
           ("gtrn", "ssd", "8", {}), ("goturn", "ncc", "8", {})]


@pytest.mark.parametrize("key,am,ssm,kw", FACTORY)
def test_factory_builds_like_jax(key, am, ssm, kw):
    """lp, its cascades with an LK refiner (the LP stage on "2" when the
    SSM has more than 4 DOF, unless `lp_ssm` says otherwise), their
    `lp_*` options, regnet with its `rg_*` options and GOTURN's analog
    (RegNet on "4" with its own defaults) build as the JAX factory builds
    them."""
    t = tcreate(key, am, ssm, device="cpu", **kw)
    j = jcreate(key, am, ssm, **kw)
    _same_build(t, j)
    for a, b in zip(list(getattr(t, "members", [t])),
                    list(getattr(j, "members", [j]))):
        for f in ("lp", "rn"):
            if hasattr(b, f):
                assert asdict(getattr(a, f)) == asdict(getattr(b, f))


@pytest.mark.parametrize("name", ["lpfc", "regnet"])
def test_convert_round_trip(name):
    """A JAX lpfc / regnet init through `convert.to_torch` and back: every
    leaf (LP's predictors and template, RegNet's MLP, features and
    scale) as the JAX package laid it out."""
    ref = _REF[name][0]
    sm = _port(LPFC if name == "lpfc" else REGNET)
    back = convert.to_numpy(convert.to_torch(ref, device="cpu", sm=sm))
    want, got = jax.tree.leaves(ref), jax.tree.leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
