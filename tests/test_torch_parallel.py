"""Port parity, the parallel layer (`mtf_tpu_torch/parallel/`): the
tracker-sharded fleet, ShardedPF, ShardedNN, ShardedGridTracker alone
and inside RKLT, `sharded_gn_step` in both modes, the strong-scaling measurement
and the dry run, each run in gloo worlds of 2, 4 and 8 processes on the
CPU, and the fleet's `update_multi` and `track_sequence`.

Each world is spawned once (`multihost.start_world`, a `file://`
rendezvous under the test's temporary directory, PyTorch on one thread
per rank) and runs every case of its size (`world_cases`); rank 0 hands
the gathered results back. The three worlds run while this process
computes the JAX references (handed to them through a file as they
are needed) and the port's unsharded results.

Tolerances: a sharded path against the port's unsharded path on the same
draws, exactly where the arithmetic is the same (the fleet, the PF's
particles and weights, the NN's dataset and corners, the grid alone and
inside RKLT) and
within 1e-4 px (`SHARD_TOL_PX`) where the sums are split over the ranks
(`sharded_gn_step`'s `local` mode, the PF's mean); against the JAX
package's unsharded counterpart within 0.05 px (`CORNER_TOL`, the chain
kernel's parity tolerance), both packages from the JAX init and, for the
PF, the NN and RANSAC, on the JAX draws (RKLT's JAX compile alone takes
20-30 s here, so RKLT is held against the port's unsharded RKLT only,
whose JAX parity `test_torch_rklt.py` holds). (The JAX package's own tests
hold its sharded paths equal to its unsharded ones; its sharded classes
compile for 73-146 s a case here, so they are not run.)
"""
import functools
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch

from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.parallel import (ShardedGridTracker, ShardedNN, ShardedPF,
                                    TrackerFleet, make_mesh, sharded_gn_step)
from mtf_tpu_torch.parallel.mesh import replicated
from mtf_tpu_torch.parallel.multihost import (measure_fleet_scaling,
                                              start_world)
from mtf_tpu_torch.sm import core
from mtf_tpu_torch.sm.composite import RKLT
from mtf_tpu_torch.sm.pf import PFDraw

SHARD_TOL_PX = 1e-4
CORNER_TOL = 0.05
WORLDS = (2, 4, 8)
H, W = 120, 160
CORNERS = np.array([[[30.31, 20.27], [70.31, 22.27], [68.31, 60.27],
                     [32.31, 58.27]],
                    [[90.31, 50.27], [132.31, 48.27], [134.31, 92.27],
                     [88.31, 94.27]]], np.float32)
BASE = dict(resx=12, resy=12, interp="linear_mm", crop=64)
PF_CASES = {
    # three sampler distributions re-weighted by their likelihood mass
    "pf_multi": ("pf", "ncc", "8", None, dict(BASE, pf_n_particles=48,
                                              pf_ssm_sigmas=(
                                                  (0.02,) * 8, (0.005,) * 8,
                                                  (0.01,) * 8))),
    # GB's photometric particles on a random walk of their own
    "pf_am_sigma": ("pf", "ssd", "8", "gb", dict(
        BASE, pf_n_particles=48, pf_am_sigma=(0.01, 1.0))),
}
NN_CFG = ("nn", "ncc", "8", dict(BASE, nn_n_samples=64, nn_dist_feat="raw",
                                 nn_add_samples_gap=1, nn_n_samples_to_add=4,
                                 max_iters=3))
# the grid alone, and inside RKLT: 3 x 3 patches, a count no world here
# divides
RKLT_CFG = dict(resx=16, resy=16, max_iters=4, epsilon=0.0,
                interp="linear_mm", crop=64, grid_res=3, grid_patch_res=6,
                grid_sub_iters=(1, 4), grid_coarse_stride=2, grid_n_hyps=16,
                coarse_pt_iters=((2, 2),))
GN_CASES = (("ssd", "local"), ("ssd", "gather"), ("ncc", "gather"))
GN_CFG = dict(resx=16, resy=16, interp="linear_mm")
FLEET_CFG = dict(resx=12, resy=12, max_iters=4, epsilon=0.0,
                 interp="linear_mm", crop=64, coarse_pt_iters=((2, 2),))
FLEET_B = 8
SCALING_TOTAL = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this process, as in each rank (beside
    XLA's compiles its OpenMP pool slows both)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def _frames():
    f = _scene()
    return f, np.roll(f, (1, 2), (0, 1))


def _shifted_frames(n, seed=5):
    """n frames: the scene shifted by a whole-pixel offset each."""
    rng = np.random.default_rng(seed)
    return np.stack([np.roll(_scene(), tuple(rng.integers(-2, 3, 2)), (0, 1))
                     for _ in range(n)])


def _fleet_corners(n):
    rng = np.random.default_rng(2)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(40, 120), rng.uniform(40, 80)
        s = rng.uniform(14, 20)
        out.append([[cx - s, cy - s], [cx + s, cy - s], [cx + s, cy + s],
                    [cx - s, cy + s]])
    return (np.asarray(out, np.float32) + 0.31).astype(np.float32)


def _np(tree):
    """A port state with numpy leaves (picklable without shared memory)."""
    return torch.utils._pytree.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, tree)


def _torch(tree):
    return torch.utils._pytree.tree_map(
        lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a,
        tree)


def _pf_draws(draws):
    return [PFDraw(*map(torch.as_tensor, d)) for d in draws]


# -- the cases of one world (every rank runs them; rank 0 reports) -------------

def _pf_case(mesh, name, ref):
    key, am, ssm, ilm, cfg = PF_CASES[name]
    sm = tcreate(key, am, ssm, ilm, device="cpu", **cfg)
    spf = ShardedPF(sm.am, sm.ssm, sm.prm, sm.pf, mesh=mesh)
    draws = _pf_draws(ref["draws"])
    spf._draw = lambda step: draws[step]
    st = spf.update(spf.place(_torch(ref["state0"])), _frames()[1])
    ex = st.extra
    return {"corners": spf.corners(st).numpy(),
            "particles": spf._all(ex.particles).numpy(),
            "log_weights": spf._all(ex.log_weights).numpy(),
            "am_particles": spf._all(ex.am_particles).numpy(),
            "distr_log_w": ex.distr_log_w.numpy()}


def _nn_case(mesh, ref):
    key, am, ssm, cfg = NN_CFG
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    snn = ShardedNN(sm.am, sm.ssm, sm.prm, sm.nn, mesh=mesh)
    data, adds = ref["draws"]
    snn._draw = lambda step, n: torch.as_tensor(
        data if step is None else adds[step])
    frame, f2 = _frames()
    built = snn.initialize(frame, CORNERS).extra
    st = snn.place(_torch(ref["state0"]))
    corners = []
    for f in (f2, frame):
        st = snn.update(st, f)
        corners.append(snn.corners(st).numpy())
    return {"init_feats": snn.shard.gather(built.feats, 1).numpy(),
            "corners": np.stack(corners),
            "feats": snn.shard.gather(st.extra.feats, 1).numpy(),
            "ptr": st.extra.ptr.numpy()}


def tie_query():
    """Features (2, 64, 5) with a duplicate pair per tracker in different
    shards of every world here (rows 3 and 40, 10 and 60) and the queries
    that hit them exactly."""
    rng = np.random.default_rng(7)
    f = rng.normal(0, 1, (2, 64, 5)).astype(np.float32)
    f[0, 40], f[1, 60] = f[0, 3], f[1, 10]
    return f, np.stack([f[0, 3], f[1, 10]])


def _tie_case(mesh):
    f, q = map(torch.as_tensor, tie_query())
    sm = tcreate("nn", "ssd", "8", device="cpu", resx=8, resy=8,
                 nn_n_samples=64)
    snn = ShardedNN(sm.am, sm.ssm, sm.prm, sm.nn, mesh=mesh)
    ns = types.SimpleNamespace(feats=snn._mine(f),
                               feats_sq=snn._mine((f * f).sum(-1)))
    return snn._best_idx(ns, q).numpy()


def sharded_rklt(sm, mesh):
    """The port's RKLT `sm` with its grid stage sharded over `mesh`."""
    g = sm.grid_sm
    return RKLT(sharded_grid(g, mesh), sm.templ_sm, sm.prm)


def sharded_grid(g, mesh):
    return ShardedGridTracker(g.am, g.ssm, g.prm, g.grid, mesh=mesh)


def _grid_case(mesh, ref):
    """The sharded grid alone from the JAX init on the JAX RANSAC draws,
    and inside RKLT from the port's init on the port's draws: the
    corners after each update of the leg."""
    grid = sharded_grid(tcreate("grid", "ssd", "8", device="cpu",
                                **RKLT_CFG), mesh)
    idx = [torch.as_tensor(i) for i in ref["hyps"]]
    grid._hyp_indices = lambda step, n: idx[step]
    srk = sharded_rklt(tcreate("rklt", "ssd", "8", device="cpu",
                               **RKLT_CFG), mesh)
    frames = ref["frames"]
    st, rk = _torch(ref["state0"]), srk.initialize(frames[0], CORNERS)
    out = []
    for f in frames[1:]:
        st, rk = grid.update(st, f), srk.update(rk, f)
        out.append((grid.corners(st).numpy(), srk.corners(rk).numpy()))
    return out


def _gn_case(mesh, am, mode, ref):
    sm = tcreate("fclk", am, "8", device="cpu", **GN_CFG)
    st = sharded_gn_step(sm, _torch(ref["state0"][am]), _frames()[1], mesh,
                         axis="pixel", mode=mode)
    return sm.corners(st).numpy()


def _fleet_case(mesh):
    fl = TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", **FLEET_CFG),
                      mesh, donate=True)
    frame, f2 = _frames()
    st = fl.update(fl.initialize(frame, _fleet_corners(FLEET_B)), f2)
    out = [fl.corners(st)]
    st = fl.update_multi(st, _shifted_frames(FLEET_B))
    out.append(fl.corners(st))
    st, seq = fl.track_sequence(st, np.stack([frame, f2]))
    return np.concatenate([torch.stack(out).numpy(), seq.numpy()])


def _rejections(n):
    """The messages of the errors every rejected configuration raises."""
    mesh = make_mesh({"particle": n}, "cpu")
    meshes = {ax: make_mesh({ax: n}, "cpu") for ax in ("sample", "tracker",
                                                       "pixel")}
    out = {}

    def expect(name, fn):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)

    gnn = tcreate("gnn", "ssd", "8", device="cpu", resx=5, resy=5,
                  nn_n_samples=8 * n)
    expect("gnn", lambda: ShardedNN(gnn.am, gnn.ssm, gnn.prm, gnn.nn,
                                    mesh=meshes["sample"]))
    nn_sm = tcreate("nn", "ssd", "8", device="cpu", resx=5, resy=5,
                    nn_n_samples=8 * n + 1)
    expect("K", lambda: ShardedNN(nn_sm.am, nn_sm.ssm, nn_sm.prm, nn_sm.nn,
                                  mesh=meshes["sample"]))
    pf_k = tcreate("pf", "ssd", "8", device="cpu", resx=5, resy=5,
                   pf_score_stride=2, pf_rescore_top_k=4)
    expect("rescore_top_k", lambda: ShardedPF(pf_k.am, pf_k.ssm, pf_k.prm,
                                              pf_k.pf, mesh=mesh))
    pf_p = tcreate("pf", "ssd", "8", device="cpu", resx=5, resy=5,
                   pf_n_particles=8 * n + 1)
    expect("P", lambda: ShardedPF(pf_p.am, pf_p.ssm, pf_p.prm, pf_p.pf,
                                  mesh=mesh))
    frame = _frames()[0]
    fl = TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", resx=5,
                              resy=5), meshes["tracker"])
    expect("B", lambda: fl.initialize(frame, _fleet_corners(n + 1)))
    lk = tcreate("fclk", "ssd", "8", device="cpu", resx=5, resy=5)
    expect("N", lambda: sharded_gn_step(lk, lk.initialize(
        frame, CORNERS), frame, meshes["pixel"]))
    return out


def _scaling(n):
    sm = tcreate("fclk", "ssd", "8", device="cpu", **FLEET_CFG)
    rng = np.random.default_rng(1)
    corners = _fleet_corners(SCALING_TOTAL)
    rng.shuffle(corners)
    return measure_fleet_scaling(sm, _scene(), lambda i: corners[i],
                                 widths=(1, 2, 4, 8), steps=2,
                                 fixed_total=SCALING_TOTAL)


def _wait_for(path, timeout=240.0):
    """The references the parent pickles to `path` while the world starts
    and runs the cases that need none."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no references at {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def world_cases(rank, n, ref_path):
    """Every case of a world of n ranks; rank 0's results."""
    from mtf_tpu_torch.parallel.dryrun import dryrun
    meshes = {ax: make_mesh({ax: n}, "cpu")
              for ax in ("tracker", "particle", "sample", "patch", "pixel")}
    one = make_mesh({"pixel": 1}, "cpu")
    out = {"tie": _tie_case(meshes["sample"]),
           "fleet": _fleet_case(meshes["tracker"]),
           "rejected": _rejections(n),
           "replicated": replicated(meshes["tracker"]).put(
               torch.full((3,), float(rank + 1))).numpy()}
    if n == 8:
        out["scaling"] = _scaling(n)
        out["dryrun"] = (dryrun("cpu"), dryrun("cpu", width=1))
    ref = _wait_for(ref_path)
    for name in PF_CASES:
        out[name] = _pf_case(meshes["particle"], name, ref["pf"][name])
    out["nn"] = _nn_case(meshes["sample"], ref["nn"])
    out["grid"] = _grid_case(meshes["patch"], ref["grid"])
    out["gn"] = {c: _gn_case(meshes["pixel"], *c, ref["gn"])
                 for c in GN_CASES}
    # the same steps on one rank
    if rank == 0:
        out["gn1"] = {c: _gn_case(one, *c, ref["gn"]) for c in GN_CASES}
    return out if rank == 0 else None


# -- the JAX references and the port's unsharded runs -----------------------

def _jax_pf_draws(seed, steps, P, S, D, P_am):
    """The JAX PF's draws (`mtf_tpu/sm/pf.py:476-484`) as numpy: per
    update `key, k_prop, k_res, k_distr, k_am = split(key, 5)`."""
    import jax
    import jax.numpy as jnp
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, k_prop, k_res, k_distr, k_am = jax.random.split(key, 5)
        prop = jax.vmap(lambda k: jax.random.normal(k, (S,), jnp.float32))(
            jax.random.split(k_prop, P))
        out.append(tuple(np.asarray(x) for x in (
            prop, jax.random.gumbel(k_distr, (P, D), jnp.float32),
            jax.random.uniform(k_res, ()),
            jax.random.normal(k_am, (P, P_am), jnp.float32))))
    return out


def _jax_fleet_run(key, am, ssm, cfg, frames, corners, ilm=None, steps=None):
    """A JAX fleet from its init over `frames[1:]` (or `steps(sm, st)`):
    (the init as numpy, the corners after each update)."""
    import jax
    import jax.numpy as jnp
    from mtf_tpu import create_tracker as jcreate
    from test_torch_fleet import jax_init
    sm = jcreate(key, am, ssm, **({"ilm": ilm} if ilm else {}), **cfg)
    st = jax_init(types.SimpleNamespace(sm=sm), frames[0], corners)
    init = jax.tree.map(np.asarray, st)
    if steps is not None:
        return sm, init, steps(sm, st)
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    out = []
    for f in frames[1:]:
        st = upd(st, jnp.asarray(f))
        out.append(np.asarray(jax.vmap(sm.corners)(st)))
    return sm, init, np.stack(out)


REF, JAX = {}, {}


def _pf_ref(name):
    key, am, ssm, ilm, cfg = PF_CASES[name]
    sm = tcreate(key, am, ssm, ilm, device="cpu", **cfg)
    draws = _jax_pf_draws(0, 1, 48, 8, max(1, len(sm.pf.ssm_sigmas)),
                          sm.am.ilm.n_params)
    _, init, corners = _jax_fleet_run(key, am, ssm, cfg, _frames(),
                                      CORNERS, ilm)
    REF.setdefault("pf", {})[name] = {
        "draws": draws, "state0": _np(convert.to_torch(init, "cpu", sm))}
    JAX[name] = corners[0]


def _nn_ref():
    from test_torch_pf_nn import jax_nn_draws
    key, am, ssm, cfg = NN_CFG
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    frame, f2 = _frames()
    _, init, corners = _jax_fleet_run(key, am, ssm, cfg, [frame, f2, frame],
                                      CORNERS)
    REF["nn"] = {"draws": jax_nn_draws(0, 64, 4, 2, 8),
                 "state0": _np(convert.to_torch(init, "cpu", sm))}
    JAX["nn"] = corners


def _grid_ref():
    """The JAX grid tracker over a 2-update synthetic leg from its init,
    on its RANSAC draws."""
    from mtf_tpu.ssm import get_ssm as jget_ssm
    from mtf_tpu.utils import synth as jsynth
    from test_torch_grid import jax_fit_indices
    frames, _ = jsynth.synthetic_sequence(_scene(), CORNERS, jget_ssm("8"),
                                          n_frames=3, sigma_scale=0.004,
                                          seed=4)
    frames = np.asarray(frames)
    sm = tcreate("grid", "ssd", "8", device="cpu", **RKLT_CFG)
    _, init, corners = _jax_fleet_run("grid", "ssd", "8", RKLT_CFG, frames,
                                      CORNERS)
    REF["grid"] = {"frames": frames, "state0": _np(convert.to_torch(
        init, "cpu", sm)), "hyps": [i.numpy() for i in jax_fit_indices(
            2, n_hyps=16, n_pts=9)]}
    JAX["grid"] = corners


def _gn_ref(am):
    """The JAX package's `sharded_gn_step` on a one-device mesh (its
    unsharded form) from its init, for each mode."""
    import jax
    from mtf_tpu.parallel import make_mesh as jmake_mesh
    from mtf_tpu.parallel import sharded_gn_step as jstep
    mesh = jmake_mesh({"pixel": 1}, devices=jax.devices()[:1])

    def steps(sm, st):
        out = {}
        for a, mode in GN_CASES:
            if a == am:
                f = jax.jit(functools.partial(
                    lambda s, fr, mode: jstep(sm, s, fr, mesh, "pixel",
                                              mode), mode=mode))
                out[mode] = np.stack([np.asarray(sm.corners(f(
                    jax.tree.map(lambda x: x[i], st), _frames()[1])))
                    for i in range(len(CORNERS))])
        return out

    sm = tcreate("fclk", am, "8", device="cpu", **GN_CFG)
    _, init, out = _jax_fleet_run("fclk", am, "8", GN_CFG, _frames(),
                                  CORNERS, steps=steps)
    REF.setdefault("gn", {"state0": {}})["state0"][am] = _np(
        convert.to_torch(init, "cpu", sm))
    for mode, c in out.items():
        JAX[("gn", am, mode)] = c


def _fleet_jax_multi():
    """The JAX fleet's `update_multi` and `track_sequence` on 3 trackers
    from its init: (the init, after update_multi, the sequence)."""
    import jax
    import jax.numpy as jnp
    from mtf_tpu import create_tracker as jcreate
    from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
    from test_torch_fleet import jax_init
    fl = JFleet(jcreate("fclk", "ssd", "8", **FLEET_CFG))
    frame, f2 = _frames()
    st = jax_init(fl, frame, _fleet_corners(3))
    init = jax.tree.map(np.asarray, st)
    st = fl.update_multi(st, jnp.asarray(_shifted_frames(3)))
    multi = np.asarray(fl.corners(st))
    _, seq = fl.track_sequence(st, jnp.asarray(np.stack([f2, frame])))
    JAX["fleet_multi"] = (init, multi, np.asarray(seq))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, _one_torch_thread):
    """The three worlds' rank-0 results. The worlds start first and run
    the cases that need no reference; the JAX references meanwhile are
    computed side by side and handed to them through a file."""
    from test_torch_fleet import side_by_side
    tmp = tmp_path_factory.mktemp("worlds")
    ref_path = tmp / "references.pkl"
    started = {n: start_world(world_cases, n, (str(ref_path),),
                              init_file=str(tmp / f"rendezvous{n}"),
                              timeout=300) for n in WORLDS}
    try:
        side_by_side([functools.partial(_pf_ref, n) for n in PF_CASES]
                     + [_fleet_jax_multi, _nn_ref, _grid_ref]
                     + [functools.partial(_gn_ref, am)
                        for am in ("ssd", "ncc")], threads=7)
    finally:
        with open(tmp / "references.tmp", "wb") as f:
            pickle.dump(dict(REF), f)
        os.replace(tmp / "references.tmp", ref_path)
    return {n: w.join()[0] for n, w in started.items()}


def _unsharded_pf(name):
    key, am, ssm, ilm, cfg = PF_CASES[name]
    sm = tcreate(key, am, ssm, ilm, device="cpu", **cfg)
    draws = _pf_draws(REF["pf"][name]["draws"])
    sm._draw = lambda step: draws[step]
    return sm, sm.update(_torch(REF["pf"][name]["state0"]), _frames()[1])


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(PF_CASES))
def test_sharded_pf_matches_pf(worlds, n, name):
    """ShardedPF on n ranks, one update from the JAX init on the JAX
    draws (with three sampler distributions; with GB's photometric
    particles): the particles, weights and photometric particles exactly
    as the PF's, the corners of its mean within 1e-4 px of the PF's and
    within 0.05 px of the JAX package's."""
    got = worlds[n][name]
    sm, st = _unsharded_pf(name)
    ex = st.extra
    np.testing.assert_array_equal(got["particles"], ex.particles.numpy())
    np.testing.assert_array_equal(got["log_weights"], ex.log_weights.numpy())
    np.testing.assert_array_equal(got["am_particles"],
                                  ex.am_particles.numpy())
    np.testing.assert_array_equal(got["distr_log_w"], ex.distr_log_w.numpy())
    want = sm.corners(st).numpy()
    assert np.abs(got["corners"] - want).max() <= SHARD_TOL_PX
    assert np.abs(want - JAX[name]).max() < CORNER_TOL


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_nn_matches_nn(worlds, n):
    """ShardedNN on n ranks: its dataset build as the NN's, and two
    updates with online additions from the JAX init on the JAX draws:
    the dataset, its ring pointer and the corners exactly as the NN's,
    and within 0.05 px of the JAX package's."""
    got = worlds[n]["nn"]
    key, am, ssm, cfg = NN_CFG
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    data, adds = REF["nn"]["draws"]
    sm._draw = lambda step, k: torch.as_tensor(
        data if step is None else adds[step])
    frame, f2 = _frames()
    np.testing.assert_array_equal(
        got["init_feats"], sm.initialize(frame, CORNERS).extra.feats.numpy())
    st = _torch(REF["nn"]["state0"])
    for t, f in enumerate((f2, frame)):
        st = sm.update(st, f)
        np.testing.assert_array_equal(got["corners"][t], sm.corners(st))
        assert np.abs(got["corners"][t] - JAX["nn"][t]).max() < CORNER_TOL
    np.testing.assert_array_equal(got["feats"], st.extra.feats.numpy())
    np.testing.assert_array_equal(got["ptr"], st.extra.ptr.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_nn_breaks_ties_to_the_lowest_index(worlds, n):
    """Two samples in different shards at the same least distance: the
    lower global index wins, as the NN's argmin."""
    f, q = map(torch.as_tensor, tie_query())
    sm = tcreate("nn", "ssd", "8", device="cpu", resx=8, resy=8,
                 nn_n_samples=64)
    want = sm._best_idx(types.SimpleNamespace(feats=f,
                                              feats_sq=(f * f).sum(-1)), q)
    np.testing.assert_array_equal(want.numpy(), [3, 10])
    np.testing.assert_array_equal(worlds[n]["tie"], want.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_grid_matches(worlds, n):
    """The grid (9 patches, padded to a multiple of n; 16 RANSAC
    hypotheses) sharded over n ranks over a 2-update synthetic leg: alone,
    from the JAX init on the JAX RANSAC draws, exactly as the unsharded
    grid and within 0.05 px of the JAX package's; inside RKLT, from the
    port's init on its draws, exactly as the unsharded RKLT."""
    grid = tcreate("grid", "ssd", "8", device="cpu", **RKLT_CFG)
    idx = [torch.as_tensor(i) for i in REF["grid"]["hyps"]]
    grid._hyp_indices = lambda step, k: idx[step]
    rklt = tcreate("rklt", "ssd", "8", device="cpu", **RKLT_CFG)
    frames = REF["grid"]["frames"]
    st, rk = _torch(REF["grid"]["state0"]), rklt.initialize(frames[0],
                                                             CORNERS)
    for t, f in enumerate(frames[1:]):
        st, rk = grid.update(st, f), rklt.update(rk, f)
        got_grid, got_rklt = worlds[n]["grid"][t]
        want = grid.corners(st).numpy()
        np.testing.assert_array_equal(got_grid, want)
        assert np.abs(want - JAX["grid"][t]).max() < CORNER_TOL
        np.testing.assert_array_equal(got_rklt, rklt.corners(rk).numpy())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("am,mode", GN_CASES)
def test_sharded_gn_step_matches(worlds, n, am, mode):
    """`sharded_gn_step` over n ranks (SSD `local`, SSD and NCC
    `gather`) from the JAX init: within 1e-4 px of the same step on one
    rank, and within 0.05 px of the JAX package's step on a one-device
    mesh."""
    got, want = worlds[n]["gn"][(am, mode)], worlds[n]["gn1"][(am, mode)]
    assert np.abs(got - want).max() <= SHARD_TOL_PX
    assert np.abs(want - JAX[("gn", am, mode)]).max() < CORNER_TOL


@pytest.mark.parametrize("n", WORLDS)
def test_tracker_sharded_fleet_matches(worlds, n):
    """A fleet of 8 trackers sharded over n ranks, donating: after an
    update on a shared frame, `update_multi` on one frame per tracker and
    a 2-frame `track_sequence`, the whole fleet's corners exactly as the
    unsharded fleet's."""
    fl = TrackerFleet(tcreate("fclk", "ssd", "8", device="cpu", **FLEET_CFG))
    frame, f2 = _frames()
    st = fl.update(fl.initialize(frame, _fleet_corners(FLEET_B)), f2)
    out = [fl.corners(st)]
    st = fl.update_multi(st, _shifted_frames(FLEET_B))
    out.append(fl.corners(st))
    st, seq = fl.track_sequence(st, np.stack([frame, f2]))
    np.testing.assert_array_equal(
        worlds[n]["fleet"], np.concatenate([torch.stack(out).numpy(),
                                            seq.numpy()]))


@pytest.mark.parametrize("n", WORLDS)
def test_replicated_puts_the_first_ranks_value(worlds, n):
    """`replicated(mesh).put` broadcasts the mesh's first rank's tensor
    (rank 0 returns what it holds after the broadcast)."""
    np.testing.assert_array_equal(worlds[n]["replicated"], [1.0, 1.0, 1.0])


@pytest.mark.parametrize("n", WORLDS)
def test_rejections_raise(worlds, n):
    """As in the JAX package: GNN and the top-K rescore rejected, and a
    sample, particle, tracker or pixel count the axis does not divide."""
    got = worlds[n]["rejected"]
    assert "GNN" in got["gnn"]
    assert "rescore_top_k" in got["rescore_top_k"]
    for k in ("K", "P", "B", "N"):
        assert "not divisible" in got[k], k


def test_strong_scaling_protocol_on_8_ranks(worlds):
    """`bench.py:225-277`'s protocol at small size: the same 16 trackers
    sharded over 1, 2, 4 and 8 ranks, each width timed; every rank gets
    the frames/s and the efficiency against one rank. (The readings
    themselves, 8 processes on a shared CPU, are not held.)"""
    got = worlds[8]["scaling"]
    assert sorted(got["fps"]) == [1, 2, 4, 8]
    assert all(v > 0 for v in got["fps"].values())
    assert got["efficiency"][1] == 1.0
    for k, v in got["efficiency"].items():
        assert v == got["fps"][k] / got["fps"][1]


def test_dry_run_on_8_ranks(worlds):
    """The dry run's five sharded paths on 8 ranks are finite, and its
    fleet's first tracker is the one-rank run's."""
    full, one = worlds[8]["dryrun"]
    assert sorted(full) == ["fleet", "gn", "nn", "pf", "rklt"]
    assert full["fleet"].shape == (8, 2, 4)
    np.testing.assert_array_equal(full["fleet"][:1], one["fleet"])


def test_update_multi_and_track_sequence_match_jax(worlds):
    """The fleet's `update_multi` on one frame per tracker and its
    `track_sequence` over a 2-frame stack, from the JAX init, within
    0.05 px of the JAX fleet's on 3 trackers; `sm/core.track_sequence`
    is the update loop."""
    init, multi, seq = JAX["fleet_multi"]
    sm = tcreate("fclk", "ssd", "8", device="cpu", **FLEET_CFG)
    fl = TrackerFleet(sm)
    st = convert.to_torch(init, "cpu", sm)
    st = fl.update_multi(st, _shifted_frames(3))
    assert np.abs(fl.corners(st).numpy() - multi).max() < CORNER_TOL
    frame, f2 = _frames()
    end, got = fl.track_sequence(st, np.stack([f2, frame]))
    assert got.shape == (2, 3, 2, 4)
    assert np.abs(got.numpy() - seq).max() < CORNER_TOL
    end2, got2 = core.track_sequence(sm, np.stack([f2, frame]), None,
                                     state0=st)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("key", ["fclk", "fclk_no_crop", "eslm", "rklt",
                                 "mf", "pyr", "line"])
def test_update_multi_is_separate_updates(key):
    """`update_multi` on 3 trackers, each on its own frame (the scene
    shifted by a sub-pixel offset), as 3 one-tracker updates on those
    frames: LK (the chain kernel's plain form on per-tracker windows, and
    with no crop on the per-tracker stack and its blur; the generic path with gather taps and done masks on whole per-tracker
    frames), RKLT, Median Flow (per-tracker previous frames), the
    pyramidal composite (its pyramid per tracker: within 1e-4 px) and
    the line tracker."""
    from scipy.ndimage import shift
    cfg = {"fclk": FLEET_CFG, "fclk_no_crop": dict(FLEET_CFG, crop=None),
           "rklt": RKLT_CFG,
           "eslm": dict(resx=12, resy=12, max_iters=4, interp="linear"),
           "mf": dict(resx=12, resy=12, interp="linear_mm", crop=64,
                      grid_sub_iters=4),
           "pyr": dict(resx=12, resy=12, max_iters=3, epsilon=0.0,
                       interp="linear_mm", crop=64, pyr_sm="fclk"),
           "line": dict(resx=12, resy=12, interp="linear_mm", crop=64,
                        grid_sub_iters=(1, 3))}[key]
    sm = tcreate(key.split("_")[0], "ssd", "8", device="cpu", **cfg)
    offs = np.random.default_rng(3).uniform(-1.5, 1.5, (3, 2))
    frames = np.stack([shift(_scene(), o, order=1, mode="nearest")
                       for o in offs]).astype(np.float32)
    corners = _fleet_corners(3)
    st = sm.update_multi(sm.initialize(_scene(), corners), frames)
    st = sm.update_multi(st, frames[::-1].copy())
    want = []
    for b in range(3):
        s1 = sm.initialize(_scene(), corners[b:b + 1])
        s1 = sm.update(sm.update(s1, frames[b]), frames[2 - b])
        want.append(sm.corners(s1).numpy()[0])
    err = np.abs(sm.corners(st).numpy() - np.stack(want)).max()
    assert err <= (SHARD_TOL_PX if key == "pyr" else 0.0), err


def test_donating_fleet_takes_per_tracker_frames():
    """A donating Median Flow fleet: its first `update_multi` makes the
    shared previous frame one per tracker, so it returns a new state;
    the next updates (per-tracker, then shared frames) write into the
    state passed in, as a fleet that does not donate steps."""
    cfg = dict(resx=12, resy=12, interp="linear_mm", crop=64,
               grid_sub_iters=3)
    frames = _shifted_frames(2)
    out = []
    for donate in (False, True):
        fl = TrackerFleet(tcreate("mf", "ssd", "8", device="cpu", **cfg),
                          donate=donate)
        st = fl.initialize(_scene(), CORNERS)
        new = fl.update_multi(st, frames)
        assert new is not st and new.extra.prev_frame.shape == (2, H, W, 1)
        again = fl.update_multi(new, frames[::-1].copy())
        assert (again is new) == donate
        out.append(fl.corners(fl.update(again, _frames()[1])).numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_update_multi_unported_sms_raise():
    """The search methods whose `update_multi` raised until it was ported
    (PF, NN, the sub-tracker grid) now step per-tracker frames through
    the fleet: on copies of one frame as `update` on it, bit for bit, and
    on per-tracker frames with finite corners. (Their parity with the JAX
    package: `tests/test_torch_multi.py`.)"""
    frames = _shifted_frames(2)
    for key, kw in (("pf", {}), ("nn", dict(nn_n_samples=8)),
                    ("grid", dict(grid_sm="fclk", crop=32))):
        sm = tcreate(key, "ssd", "8", device="cpu", resx=8, resy=8, **kw)
        fl = TrackerFleet(sm)
        st = fl.initialize(_scene(), CORNERS)
        a = fl.corners(fl.update_multi(st, np.stack([frames[0]] * 2)))
        assert torch.equal(a, fl.corners(fl.update(st, frames[0]))), key
        assert torch.isfinite(fl.corners(fl.update_multi(st, frames))).all()
