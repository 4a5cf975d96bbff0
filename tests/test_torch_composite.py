"""Port parity, slice 5's composites: RKLT with cubic taps (K5c in its
grid, K1c in its refiner), the cascade shorthand grfc (grid, then FCLK),
ParallelSM (FCLK and ESM fused by their mean corners) and PyramidalSM
(FCLK on a 3-level Gaussian pyramid), each stepped by `mtf_tpu_torch`
and by the JAX package on the same synthetic sequence, corners within
0.05 px per frame; the cascade's per-tracker auto-reinit; and the state
conversions of the composites.

The LK members run a shortened schedule (4 full-resolution iterations,
no coarse phase) to keep the JAX compiles short; the card runs the
benchmark's 6 + 3 + 1 (`chip_smoke.py`), and the coarse phases are held
against the JAX package in `test_torch_fleet.py` and the slice files.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm.composite import CompositeState as JCompositeState
from mtf_tpu.utils import synth as jsynth
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.sm.composite import (CascadeSM, CompositeState,
                                        ParallelSM, PyramidalSM, where_state)
from mtf_tpu_torch.sm.grid import GridTracker
from test_torch_fleet import CORNER_TOL, CORNERS, _scene, side_by_side
from test_torch_grid import GRID_CORNERS, jax_fit_indices, use_indices

LK_CFG = dict(resx=50, resy=50, max_iters=4, epsilon=0.0,
              interp="linear_mm", crop=144, coarse_pt_iters=())
RK_CFG = dict(LK_CFG, crop=160, grid_sub_iters=(1, 8), grid_coarse_stride=2)
MEMBERS = [("fclk", "ssd", "8"), ("esm", "ssd", "8")]
# name: (SM key, options, corners, the JAX path: Pallas in interpret mode
# or XLA)
CASES = {
    "rklt_cubic": ("rklt", dict(RK_CFG, interp="cubic_mm"), GRID_CORNERS,
                   False),
    "grfc": ("grfc", RK_CFG, GRID_CORNERS, False),
    "prl": ("prl", dict(LK_CFG, members=MEMBERS), CORNERS, False),
    "pyr": ("pyr", dict(LK_CFG, pyr_sm="fclk", pyr_n_levels=3), CORNERS,
            False),
}
SEQ_SEED = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small CPU runs here take one thread: beside XLA's CPU
    thread pool, PyTorch's spinning OpenMP threads slowed them ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(sm):
    return [m for m in sm.modules() if isinstance(m, GridTracker)]


def _jax_ref(name):
    """Two JAX updates of case `name` on a 3-frame synthetic sequence,
    with its initial state."""
    key, cfg, corners, pallas = CASES[name]
    fl = JFleet(jcreate(key, "ssd", "8", use_pallas=pallas, **cfg))
    frames, gt = jsynth.synthetic_sequence(
        _scene(0), corners, fl.sm.ssm, n_frames=3, sigma_scale=0.004,
        seed=SEQ_SEED)
    frames = np.asarray(frames)
    st = fl.initialize(frames[0], corners)
    out = {"frames": frames, "gt": gt, "corners": [],
           "state0": jax.tree.map(np.asarray, st)}
    if key == "rklt":
        # RKLT.update never reads the final-corner slot: a placeholder
        # keeps one compiled step for both updates
        st = JCompositeState(st.members, (jnp.zeros(corners.shape),))
    for t in (1, 2):
        st = fl.update(st, frames[t])
        out["corners"].append(np.asarray(fl.corners(st)))
    return out


@pytest.fixture(scope="module")
def ref():
    """Every case's JAX reference (`_jax_ref`), computed once, the four
    compiles side by side on first use."""
    cache = {}

    def fill(name):
        cache[name] = _jax_ref(name)

    def get(name):
        if not cache:
            side_by_side([functools.partial(fill, n) for n in CASES])
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_composite_matches_jax_per_frame(ref, name):
    """Each frame within 0.05 px of the JAX package, and within 0.2 px of
    the exact ground truth on average."""
    key, cfg, corners, _ = CASES[name]
    r = ref(name)
    sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
    for g in _grids(sm):
        use_indices(g, jax_fit_indices(2))
    fl = TrackerFleet(sm)
    st = fl.initialize(r["frames"][0], corners)
    for t in (1, 2):
        st = fl.update(st, r["frames"][t])
        got = fl.corners(st).numpy()
        assert np.abs(got - r["corners"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - r["gt"][t],
                             axis=-1)
        assert np.isfinite(err).all() and err.mean() < 0.2, (t, err)


def _assert_same(js, ps):
    """The JAX state `js` and the port's state in the JAX layout `ps`
    hold the same arrays field by field (the JAX key, which the port
    replaces by its step counter, and an `extra` the JAX state has not
    filled yet are skipped; a JAX field the port has no counterpart of
    must be None)."""
    if hasattr(js, "_fields"):
        for f in js._fields:
            if f == "key" or (f == "extra" and hasattr(js, "members")
                              and not js.extra):
                continue
            if f not in ps._fields:
                assert getattr(js, f) is None, f
                continue
            _assert_same(getattr(js, f), getattr(ps, f))
    elif isinstance(js, tuple):
        assert isinstance(ps, tuple) and len(ps) == len(js)
        for a, b in zip(js, ps):
            _assert_same(a, b)
    elif js is None:
        assert ps is None
    else:
        np.testing.assert_array_equal(np.asarray(ps, np.float32),
                                      np.asarray(js, np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_composite_state_converts(ref, name):
    """The JAX initial state -> the port (which composite it is read from
    the port's tracker) -> the JAX layout: every array as it was; a
    parallel state gets its fused corners, and the converted state steps
    like the port's own."""
    key, cfg, corners, _ = CASES[name]
    r = ref(name)
    sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
    st = convert.to_torch(r["state0"], "cpu", sm)
    _assert_same(r["state0"], convert.to_numpy(st))
    own = sm.initialize(r["frames"][0], corners)
    np.testing.assert_allclose(sm.corners(st).numpy(),
                               sm.corners(own).numpy(), atol=1e-3, rtol=0)
    if name == "prl":
        assert isinstance(sm, ParallelSM) and len(st.extra) == 1
    if name in ("grfc", "pyr"):
        assert isinstance(sm, (CascadeSM, PyramidalSM)) and st.extra == ()


def test_composites_donate_in_place():
    """A donating fleet writes every replaced tensor of a nested
    composite's state into the state passed in (the cascade's grid and
    FCLK members, the parallel composite's fused corners)."""
    frame = _scene(0)
    f2 = np.roll(frame, (1, 1), (0, 1))
    for key, cfg, corners in (("grfc", RK_CFG, GRID_CORNERS),
                              ("prl", dict(LK_CFG, members=MEMBERS),
                               CORNERS)):
        sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
        want = sm.update(sm.initialize(frame, corners), f2)
        st = sm.initialize(frame, corners)
        out = TrackerFleet(sm, donate=True).update(st, f2)
        assert out is st
        np.testing.assert_array_equal(sm.corners(out).numpy(),
                                      sm.corners(want).numpy())


def test_cascade_reinit_is_per_tracker(monkeypatch):
    """A cascade of two FCLK members with `casc_reinit_thresh` 5 px, the
    second member's result pushed 20 px off for tracker 1 only: tracker 1
    is reset to the first member's corners (its second member re-seated
    there), tracker 0 keeps the second member's result (up to the refit
    of its unmoved corners)."""
    frame = _scene(0)
    f2 = np.roll(frame, (1, 1), (0, 1))
    cfg = dict(LK_CFG, members=[("fclk", "ssd", "8")] * 2)
    plain = tcreate("casc", "ssd", "8", device="cpu", **cfg)
    sm = tcreate("casc", "ssd", "8", device="cpu", casc_reinit_thresh=5.0,
                 **cfg)
    second = sm.members[1]
    real = second.update

    def pushed(st, frm):
        st = real(st, frm)
        c = second.corners(st).transpose(-1, -2).clone()
        c[1] += 20.0
        return second.set_region(st, c)

    monkeypatch.setattr(second, "update", pushed)
    want = plain.update(plain.initialize(frame, CORNERS), f2)
    got = sm.update(sm.initialize(frame, CORNERS), f2)
    first_c = sm.members[0].corners(got.members[0])
    np.testing.assert_allclose(sm.corners(got)[0].numpy(),
                               plain.corners(want)[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(sm.corners(got)[1].numpy(),
                               first_c[1].numpy(), atol=1e-3)
    np.testing.assert_allclose(got.members[1].ssm_state[0].numpy(),
                               want.members[1].ssm_state[0].numpy(),
                               atol=1e-5)


def test_where_state_keeps_shared_leaves():
    """`where_state` picks per tracker in every batched leaf and keeps a
    leaf that both states share (the grid's host step counter, its shared
    previous frame); an unbatched leaf that differs raises."""
    shared = torch.zeros(4, 5)
    a = CompositeState((torch.ones(2, 3), shared), extra=(torch.ones(2),))
    b = CompositeState((torch.zeros(2, 3), shared), extra=(torch.zeros(2),))
    out = where_state(torch.tensor([True, False]), a, b)
    assert out.members[1] is shared
    np.testing.assert_array_equal(out.members[0].numpy(),
                                  [[1, 1, 1], [0, 0, 0]])
    with pytest.raises(ValueError, match="not batched"):
        where_state(torch.tensor([True, False]), (torch.ones(4, 5),),
                    (torch.zeros(4, 5),))


def test_composite_factory_keys():
    """Every alias builds its composite as the JAX package's factory
    does; the shorthands, `multi_cfg` and grid_sm other than flow / cv
    that are not ported raise naming their queue."""
    for keys, cls, kw in (
            (("casc", "casm", "cascade"), CascadeSM,
             {"members": MEMBERS}),
            (("prl", "prlt", "prls", "prsm", "parallel"), ParallelSM,
             {"members": MEMBERS}),
            (("pyr", "pyrt", "pysm", "pyrs"), PyramidalSM, {}),
            (("grfc", "gres"), CascadeSM, {})):
        for key in keys:
            t = tcreate(key, "ssd", "8", device="cpu", **LK_CFG, **kw)
            j = jcreate(key, "ssd", "8", **LK_CFG, **kw)
            assert isinstance(t, cls) and type(j).__name__ == cls.__name__
            names = [type(m).__name__ for m in t.members]
            want = [type(m).__name__ for m in getattr(j, "members", [])] \
                or [type(j.sm).__name__]
            assert names == want, key
    with pytest.raises(ValueError, match="members"):
        tcreate("casc", "ssd", "8", device="cpu", **LK_CFG)


@pytest.mark.parametrize("key,kw", [
    ("mf", {}), ("grfc", {}), ("prl", {"members": MEMBERS}), ("pyr", {})])
def test_new_keys_default_to_the_card(monkeypatch, key, kw):
    """Without `device` the slice's trackers resolve to the card, and
    raise where there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcreate(key, "ssd", "8", **RK_CFG, **kw)
