"""Port parity, slice 12's correlation filters: `ops/hog.py` and MOSSE,
KCF and DSST (`mtf_tpu_torch/sm/cf.py`) against the JAX package's
(`mtf_tpu/ops/hog.py`, `mtf_tpu/sm/cf.py`), with the factory keys and
the state converters.

The references are lone JAX trackers (one `initialize` / `update` per
tracker, the JAX package's own protocol) run op by op, as the port runs
its ops: under `jit` XLA contracts the window sampling's multiplies and
adds, which moves a patch by an ulp, and fHOG's orientation snap (an
argmax) can then flip for one pixel (DSST's scale moved 6.4e-6 and its
corners 0.047 px after 3 updates, jitted and vmapped JAX against op by
op). The port's B trackers are one batched fleet. Frames: the test scene
moved by whole pixels, boxes off the pixel grid. Widths are cut
(`res` 32, 9 DSST scales of 8 cells) to keep the op-by-op references
short.

The JAX references of the three slice-12 files (`REFERENCE_JOBS` of each)
are computed in a pool of REF_WORKERS spawned processes (`reference`):
op by op, a reference is mostly XLA compiles of single ops, which run
side by side in processes but not in threads. A file's jobs start when
its first test does; in a run without xdist, those of every slice-12 file
selected in the session start then too, the longest first.

Tolerances: `hog` within 1e-4 of its norm, corners within 0.05 px, a JAX
state carried across by `convert.to_torch` within 0.05 px after one more
update.
"""
import atexit
import concurrent.futures
import multiprocessing
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops.hog import hog as jhog
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops.hog import hog as thog
from mtf_tpu_torch.parallel import TrackerFleet
from test_torch_fleet import _scene

CORNER_TOL = 0.05
HOG_REL = 1e-4
# B = 4 boxes off the pixel grid, of several aspect ratios
BOXES = np.array([[[100.3, 80.2], [150.1, 80.2], [150.1, 131.7],
                   [100.3, 131.7]],
                  [[180.4, 60.6], [230.9, 60.6], [230.9, 100.1],
                   [180.4, 100.1]],
                  [[60.7, 140.3], [121.2, 140.3], [121.2, 190.6],
                   [60.7, 190.6]],
                  [[200.1, 150.4], [244.6, 150.4], [244.6, 201.9],
                   [200.1, 201.9]]], np.float32)
MOTION = ((2, 1), (4, 2), (5, 4))     # (dx, dy) of frames 1-3
CF_SMALL = dict(res=32, n_scales=9, scale_res=8)
CF_CASES = [(key, feat) for key in ("mosse", "kcf", "dsst")
            for feat in ("gray", "hog")]


# ~0.7 GB a worker; under xdist every file runs beside the other workers
REF_WORKERS = 3 if "PYTEST_XDIST_WORKER" in os.environ else 6
_POOL = []
_FUTURES = {}


def _worker_init():
    import jax
    jax.config.update("jax_platforms", "cpu")


def submit(fn, *args):
    """Start `fn(*args)` (a top-level function of a test module, returning
    numpy) in the reference pool, once."""
    if not _POOL:
        _POOL.append(concurrent.futures.ProcessPoolExecutor(
            REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init))
        atexit.register(_POOL[0].shutdown, cancel_futures=True)
    key = (fn.__module__, fn.__name__, args)
    if key not in _FUTURES:
        _FUTURES[key] = _POOL[0].submit(fn, *args)
    return _FUTURES[key]


def reference(fn, *args):
    return submit(fn, *args).result()


SLICE12_MODULES = ("test_torch_tld", "test_torch_cf", "test_torch_learn")


def start_references(request):
    """Submit the reference jobs of this module and, outside xdist, of
    every slice-12 module with a selected test (`SLICE12_MODULES` order,
    the longest job first)."""
    mods = {request.module.__name__}
    if "PYTEST_XDIST_WORKER" not in os.environ:
        mods |= {it.module.__name__ for it in request.session.items
                 if it.module.__name__ in SLICE12_MODULES}
    for m in SLICE12_MODULES:
        if m in mods:
            for job in sys.modules[m].REFERENCE_JOBS:
                submit(*job)


def frames_of(scene, motion=MOTION):
    return [scene] + [np.roll(scene, (dy, dx), (0, 1)) for dx, dy in motion]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this module, beside XLA."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lone_jax(key, cfg, frames, boxes):
    """Each box tracked alone by the JAX package, op by op: (the init
    states stacked into one batched numpy state, each frame's corners
    (T, B, 2, 4), the states after update 1 stacked)."""
    jt = jcreate(key, **cfg)
    states = [jt.initialize(jnp.asarray(frames[0]), jnp.asarray(c))
              for c in boxes]
    init = jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]),
                        *states)
    out, after1 = [], None
    for f in frames[1:]:
        states = [jt.update(s, jnp.asarray(f)) for s in states]
        if after1 is None:
            after1 = jax.tree.map(
                lambda *x: np.stack([np.asarray(a) for a in x]), *states)
        out.append(np.stack([np.asarray(jt.corners(s)) for s in states]))
    return init, np.stack(out), after1


def cf_reference(key, feat):
    return lone_jax(key, dict(CF_SMALL, features=feat), frames_of(_scene()),
                    BOXES)


def hog_images():
    rng = np.random.default_rng(4)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (3, 64, 48)), 1), 2)
    img = ((img - img.min()) / np.ptp(img) * 255.0).astype(np.float32)
    return np.concatenate([img, np.full((1, 64, 48), 7.0, np.float32)])


def hog_reference():
    """The JAX package's fHOG of `hog_images` at cells 2 and 4."""
    return {cell: np.stack([np.asarray(jhog(jnp.asarray(x), 9, cell))
                            for x in hog_images()]) for cell in (2, 4)}


def mosse_scale_reference():
    """The JAX MOSSE's scale after `set_region` to 1.1x the first box."""
    jt = jcreate("mosse", res=32)
    st = jt.initialize(jnp.asarray(_scene()), jnp.asarray(BOXES[0]))
    return float(jt.set_region(st, jnp.asarray(BOXES[0] * 1.1)).scale)


REFERENCE_JOBS = ([(hog_reference,), (cf_reference, "dsst", "hog")]
                  + [(cf_reference, *c) for c in CF_CASES
                     if c != ("dsst", "hog")]
                  + [(mosse_scale_reference,)])


@pytest.fixture(scope="module", autouse=True)
def _references(request):
    start_references(request)


def port_run(sm, frames, boxes):
    """The port's fleet of all boxes: each frame's corners (T, B, 2, 4)."""
    fleet = TrackerFleet(sm)
    st = fleet.initialize(frames[0], boxes)
    out = []
    for f in frames[1:]:
        st = fleet.update(st, f)
        out.append(fleet.corners(st).numpy())
    return np.stack(out)


def check_continuation(sm, ref, frames, label):
    """The JAX init state carried across by `convert.to_torch` continues
    as the JAX trackers do: one port update from it within CORNER_TOL of
    the JAX corners after update 1."""
    init, corners, _ = ref
    st = convert.to_torch(init, device="cpu", sm=sm)
    got = sm.corners(sm.update(st, frames[1])).numpy()
    err = float(np.abs(got - corners[0]).max())
    assert err <= CORNER_TOL, (label, err)
    back = convert.to_numpy(st)
    np.testing.assert_array_equal(back.center, init.center)


@pytest.mark.parametrize("cell", [2, 4])
def test_hog_matches_jax(cell):
    """fHOG of 3 smooth patches and a flat one (which projects 0 on every
    orientation: its votes go to bin 0, as `jnp.argmax` takes the first
    maximum) within 1e-4 of the JAX package's."""
    img = hog_images()
    want = reference(hog_reference)[cell]
    got = thog(torch.tensor(img), 9, cell).numpy()
    assert got.shape == want.shape == (4, 64 // cell, 48 // cell, 31)
    assert rel(got[:3], want[:3]) <= HOG_REL, (cell, rel(got, want))
    assert rel(got[3:], want[3:]) <= HOG_REL


@pytest.mark.parametrize("key,feat", CF_CASES)
def test_cf_matches_lone_jax_trackers(key, feat):
    """A B = 4 fleet of each CF key with gray and fHOG features, init and 3
    updates, against 4 lone JAX trackers; then the JAX init state carried
    across continues identically."""
    frames = frames_of(_scene())
    ref = reference(cf_reference, key, feat)
    sm = tcreate(key, device="cpu", **dict(CF_SMALL, features=feat))
    got = port_run(sm, frames, BOXES)
    err = np.abs(got - ref[1]).max(axis=(1, 2, 3))
    assert np.all(err <= CORNER_TOL), (key, feat, err)
    check_continuation(sm, ref, frames, f"{key}/{feat}")


def test_cf_factory_defaults():
    """The JAX factory's defaults: MOSSE gray, KCF and DSST fHOG (32
    channels) with KCF's HOG kernel bandwidth 0.5."""
    for key, feat, c in (("mosse", "gray", 1), ("kcf", "hog", 32),
                         ("dsst", "hog", 32)):
        t, j = tcreate(key, device="cpu"), jcreate(key)
        assert t.prm.features == feat and t.n_channels == c == j.n_channels
        assert t.prm == type(t.prm)(**j.prm.__dict__)
    assert tcreate("kcf", device="cpu").prm.kernel_sigma == 0.5
    assert tcreate("kcf", device="cpu",
                   features="gray").prm.kernel_sigma == 0.2


def test_cf_psr_gate_and_set_region():
    """The PSR gate skips learning below threshold (no filter change), and
    `set_region` moves and rescales the box, as in the JAX package."""
    frames = frames_of(_scene())
    sm = tcreate("mosse", device="cpu", res=32, psr_thresh=1e9)
    st = sm.initialize(frames[0], BOXES[:2])
    st2 = sm.update(st, frames[1])
    torch.testing.assert_close(st2.num, st.num, rtol=0, atol=0)
    assert torch.all(torch.isfinite(st2.psr))
    c2 = BOXES[:2] * 1.1
    st3 = sm.set_region(st2, c2)
    np.testing.assert_allclose(sm.corners(st3).numpy().transpose(0, 2, 1),
                               c2, atol=1e-3)
    np.testing.assert_allclose(float(st3.scale[0]),
                               reference(mosse_scale_reference), rtol=1e-6)


def test_cf_update_multi_is_the_shared_path():
    """`update_multi` on B copies of the frame equals `update` on it."""
    frames = frames_of(_scene())
    sm = tcreate("dsst", device="cpu", **CF_SMALL)
    st = sm.initialize(frames[0], BOXES)
    a = sm.corners(sm.update(st, frames[1]))
    b = sm.corners(sm.update_multi(st, np.stack([frames[1]] * 4)))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
