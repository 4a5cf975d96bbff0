"""Port parity, per-tracker frames (`update_multi`) of the search methods
that took them last: PF, NN, LP (the lpfc cascade), RegNet, the
sub-tracker grid, DFT (on ESM and on FCLK) and pfrk, against the JAX
package's `TrackerFleet.update_multi` (`vmap(sm.update, in_axes=(0, 0))`).

3 trackers at small widths on the test scene, their corners off the pixel
grid (ROADMAP Queue 3, item 2); the per-tracker frames are
the scene shifted by sub-pixel offsets (each tracker its own), two
updates (the frames, then in reverse order). Every case checks that
`update_multi` on 3 copies of one frame is `update` on that frame, bit
for bit, and that two `update_multi` from the JAX init
(`convert.to_torch`) are within 0.05 px of the JAX fleet's, the port
handed the JAX draws (PF and NN: `test_torch_pf_nn.inject`; RANSAC:
`test_torch_grid.use_indices`). Every JAX pfrk update raises (ROADMAP
Queue 3, item 13): pfrk is held to its two members stepped by the JAX
parts, as `test_torch_pf_nn.py`'s cascade test holds it. The
deterministic search methods' `update_multi` is also each tracker's
update alone on its frames, bit for bit. The JAX references are
computed in the spawned reference pool (`test_torch_cf.submit`: traces
and compiles side by side in processes, not threads), those of both
slice-15 files from the first one's start, while the port-only tests
run.
"""
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.utils import preproc as jpreproc
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.utils import preproc
from test_torch_cf import reference, submit
from test_torch_fleet import CORNER_TOL, CORNERS, _scene, jax_init
from test_torch_grid import jax_fit_indices, use_indices
from test_torch_pf_nn import CASCADE_RK, inject

BASE = dict(resx=16, resy=16, interp="linear_mm", crop=96)
CASES = {
    # online additions from each tracker's frame
    "nn": ("nn", "ssd", "8", dict(BASE, nn_n_samples=64,
                                  nn_add_samples_gap=1,
                                  nn_n_samples_to_add=4)),
    "lpfc": ("lpfc", "ssd", "8", dict(BASE, max_iters=5, epsilon=0.0,
                                      lp_n_samples=64, lp_n_stages=2,
                                      coarse_pt_iters=((2, 2),))),
    "regnet": ("regnet", "ssd", "2", dict(BASE, interp="linear",
                                          rg_n_samples=96,
                                          rg_hidden=(16, 8),
                                          rg_train_steps=20,
                                          rg_pix_sigma=3.0)),
    # 25 fclk/ssd/2 sub-trackers per tracker, reading their parent's
    # frame by index
    "subgrid": ("grid", "ssd", "8", dict(
        resx=50, resy=50, max_iters=6, epsilon=0.0, interp="linear_mm",
        crop=32, grid_sm="fclk", grid_res=5, coarse_pt_iters=((2, 3),))),
    "dft_esm": ("dft", "ssd", "8", dict(resx=16, resy=16, max_iters=5,
                                        epsilon=0.0)),
    "dft_fclk": ("dft", "ssd", "8", dict(dft_sm="fclk", resx=16, resy=16,
                                         max_iters=5, epsilon=0.0,
                                         interp="linear_mm", crop=96)),
    # pf500's measurement: the stride-4 ranking of the blurred and
    # downsampled frame (each tracker's own), the top K rescored in
    # their window
    "pf": ("pf", "ssim", "8", dict(
        BASE, pf_n_particles=48, pf_score_stride=4, pf_score_blur=True,
        pf_score_downsample=True, pf_rescore_top_k=16, pf_rescore_crop=64,
        pf_likelihood="am")),
    "pfrk": ("pfrk", "ssd", "8", CASCADE_RK["pfrk"]),
}
DETERMINISTIC = ("lpfc", "regnet", "subgrid", "dft_esm", "dft_fclk")
# off the pixel grid (ROADMAP Queue 3, item 2)
CORNERS = (CORNERS + np.float32([0.31, 0.27])).astype(np.float32)
OFFSETS = np.random.default_rng(3).uniform(-1.5, 1.5, (3, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread beside XLA's compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _frames():
    """Per-tracker frames (3, H, W): the scene shifted by OFFSETS."""
    return np.stack([shift(_scene(), o, order=1, mode="nearest")
                     for o in OFFSETS]).astype(np.float32)


def _port(name, seed_draws=True):
    """The port's tracker of case `name`, handed the JAX draws."""
    key, am, ssm, cfg = CASES[name]
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    if not seed_draws:
        return sm
    inject(sm, steps=2)
    if key == "grid":
        use_indices(sm, jax_fit_indices(2, n_pts=25))
    elif key == "pfrk":
        use_indices(sm.members[1].grid_sm, jax_fit_indices(2, n_hyps=16,
                                                            n_pts=16))
    return sm


def jax_reference(name):
    """The JAX init state and its corners after each of two
    `update_multi` (numpy); pfrk's by its JAX parts."""
    key, am, ssm, cfg = CASES[name]
    sm = jcreate(key, am, ssm, **cfg)
    st = jax_init(types.SimpleNamespace(sm=sm), _scene(), CORNERS)
    out = {"state0": jax.tree.map(np.asarray, st), "corners": []}
    frames = _frames()
    if key == "pfrk":
        first, rk = sm.members
        upd0 = jax.jit(jax.vmap(first.update, in_axes=(0, 0)))
        upd1 = jax.jit(jax.vmap(lambda s, c, f: rk.update(rk.set_region(
            s, c), f), in_axes=(0, 0, 0)))
        m0, m1 = st.members
        for f in (frames, frames[::-1]):
            m0 = upd0(m0, jnp.asarray(f))
            c = jnp.swapaxes(jax.vmap(first.corners)(m0), 1, 2)
            m1 = upd1(m1, c, jnp.asarray(f))
            out["corners"].append(np.asarray(jax.vmap(rk.corners)(m1)))
    else:
        fl = JFleet(sm)
        for f in (frames, frames[::-1]):
            st = fl.update_multi(st, jnp.asarray(f))
            out["corners"].append(np.asarray(fl.corners(st)))
    return out


# every reference job of the module, the two longest (pfrk ~22 s alone,
# pf ~7 s; their parity tests run last) first
REFERENCE_JOBS = [(jax_reference, n) for n in
                  ("pfrk", "pf", "nn", "lpfc", "regnet", "subgrid",
                   "dft_esm", "dft_fclk")]
SLICE15_MODULES = ("test_torch_multi", "test_torch_options")


def start_references(request):
    """Submit the reference jobs of this module and, outside xdist, of
    every slice-15 module with a selected test, to the spawned reference
    pool (`test_torch_cf.submit`)."""
    mods = {request.module.__name__}
    if "PYTEST_XDIST_WORKER" not in os.environ:
        mods |= {it.module.__name__ for it in request.session.items
                 if it.module.__name__ in SLICE15_MODULES}
    for m in SLICE15_MODULES:
        if m in mods:
            for job in sys.modules[m].REFERENCE_JOBS:
                submit(*job)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(request, _one_torch_thread):
    start_references(request)


@pytest.mark.parametrize("name", list(CASES))
def test_update_multi_on_copies_is_update(name):
    """`update_multi` on 3 copies of one frame is `update` on that frame,
    bit for bit (the same draws: a function of the update count)."""
    sm = _port(name, seed_draws=False)
    st = sm.initialize(_scene(), CORNERS)
    f = _frames()[1]
    a = sm.update_multi(st, np.stack([f] * 3))
    b = sm.update(st, f)
    assert torch.equal(sm.corners(a), sm.corners(b))


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_update_multi_is_separate_updates(name):
    """The deterministic search methods: `update_multi` on 3 trackers is
    each tracker updated alone on its own frames, bit for bit (lpfc
    within 1e-4 px: its init's batched ridge solves round differently
    for one tracker and for three)."""
    sm = _port(name, seed_draws=False)
    frames = _frames()
    st = sm.initialize(_scene(), CORNERS)
    st = sm.update_multi(sm.update_multi(st, frames), frames[::-1].copy())
    tol = 1e-4 if name == "lpfc" else 0.0
    for b in range(3):
        s1 = sm.initialize(_scene(), CORNERS[b:b + 1])
        s1 = sm.update(sm.update(s1, frames[b]), frames[2 - b])
        err = (sm.corners(s1)[0] - sm.corners(st)[b]).abs().max()
        assert err <= tol, (b, float(err))


def test_sub_grid_without_a_window_reads_frames_by_index(monkeypatch):
    """The sub-tracker grid with no window (crop over the frame): its
    sub-trackers read their parents' frames by index, the chain kernel
    once per parent frame and iteration (never a frame per sub-tracker);
    `update_multi` is each tracker updated alone, bit for bit."""
    from mtf_tpu_torch.sm import lk as lk_mod
    sm = tcreate("grid", "ssd", "8", device="cpu", grid_res=3, crop=1000,
                 grid_sm="fclk", max_iters=2, epsilon=0.0,
                 interp="linear_mm")
    frames = _frames()
    st = sm.initialize(_scene(), CORNERS)
    calls, chain = [], lk_mod.lk_fused_chain

    def spy(window, *a, **kw):
        calls.append(window.shape[0])
        return chain(window, *a, **kw)

    monkeypatch.setattr(lk_mod, "lk_fused_chain", spy)
    got = sm.corners(sm.update_multi(st, frames))
    assert calls == [9] * 6              # 3 frames x 2 iterations, 9 each
    for b in range(3):
        s1 = sm.initialize(_scene(), CORNERS[b:b + 1])
        assert torch.equal(sm.corners(sm.update(s1, frames[b]))[0], got[b])


def test_batched_descriptor_fields():
    """`descriptor_fields` of a (B, H, W) stack in one pass is each
    frame's, bit for bit, and within 1e-5 of their scale of the JAX
    package's (RGB frames too)."""
    frames = _frames()
    got = preproc.descriptor_fields(torch.tensor(frames), batched=True)
    assert got.shape == frames.shape + (4,)
    for b in range(3):
        assert torch.equal(got[b],
                           preproc.descriptor_fields(torch.tensor(frames[b])))
    want = np.asarray(jax.jit(jpreproc.descriptor_fields)(
        jnp.asarray(frames[0])))
    assert np.abs(got[0].numpy() - want).max() <= 1e-5 * np.abs(want).max()
    rgb = np.stack([frames, frames[:, ::-1, ::-1], frames[::-1]], -1)
    got3 = preproc.descriptor_fields(torch.tensor(rgb), batched=True)
    assert torch.equal(got3[2], preproc.descriptor_fields(
        torch.tensor(rgb[2].copy())))
    want3 = np.asarray(jax.jit(jpreproc.descriptor_fields)(
        jnp.asarray(rgb[2])))
    assert np.abs(got3[2].numpy() - want3).max() <= 1e-5 * np.abs(
        want3).max()


@pytest.mark.parametrize("name", list(CASES))
def test_update_multi_matches_jax(name):
    """Two `update_multi` from the JAX init on the JAX draws, each within
    0.05 px of the JAX fleet's (pfrk: of its JAX parts')."""
    ref = reference(jax_reference, name)
    sm = _port(name)
    st = convert.to_torch(ref["state0"], device="cpu", sm=sm)
    frames = _frames()
    for t, f in enumerate((frames, frames[::-1].copy())):
        st = sm.update_multi(st, f)
        got = sm.corners(st).numpy()
        assert np.isfinite(got).all(), t
        assert np.abs(got - ref["corners"][t]).max() < CORNER_TOL, t
