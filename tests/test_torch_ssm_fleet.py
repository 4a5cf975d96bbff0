"""Port parity, slice 6 as a whole: fleets on the matrix SSMs other than
the homography (the chain kernel at S = the SSM's DOF) and the
conversion of their states; RKLT on the affine SSM, the sub-tracker grid
and grfc are in `test_torch_ssm_grid.py`, which shares this file's
configurations and JAX runs.

Each fleet is stepped by `mtf_tpu_torch` and by the JAX package on the
same frames, from the same init; corners must agree within 0.05 px (the
chain kernel's parity tolerance, `tests/test_r5_features.py:50,60,72,92`).
The grids are handed the JAX package's RANSAC index draws. Every JAX
configuration is compiled once per module (`_jax_run`), on 3 trackers
with the fleets' templates and window (50x50, 144 px) on a 240x320
scene, and 6 full-resolution iterations without coarse phases (each
phase is one more JAX loop to compile, ~2.5 s here; the coarse phases
are held at every S by the kernel tests and at S = 8 by the earlier
fleet files). The sub-tracker grid keeps one stride-2 phase
(`chip_smoke.SUBGRID_COARSE`).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.sm.composite import CompositeState as JCompositeState
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.ssm import get_ssm as tget_ssm
from mtf_tpu_torch.utils import synth as tsynth
from test_torch_fleet import CORNER_TOL, CORNERS, _scene, jax_init, \
    side_by_side
from test_torch_grid import jax_fit_indices, use_indices

CFG = dict(resx=50, resy=50, max_iters=6, epsilon=0.0, interp="linear_mm",
           crop=144)
RKLT_CFG = dict(CFG, crop=160, grid_sub_iters=(1, 8), grid_coarse_stride=2)
SUB_CFG = dict(CFG, crop=32, grid_sm="fclk", grid_res=5,
               coarse_pt_iters=((2, 3),))
# (name, SM, AM, SSM, configuration, JAX path)
FLEETS = {
    "fclk_ssd_6": ("fclk", "ssd", "6", CFG, None),
    "fclk_ssd_6_pallas": ("fclk", "ssd", "6", CFG, True),
    "esm_ncc_4": ("esm", "ncc", "4", CFG, None),
    "fclk_ssd_l8": ("fclk", "ssd", "l8", CFG, None),
    "fclk_ssd_c8": ("fclk", "ssd", "c8", CFG, None),
    "rklt_ssd_6": ("rklt", "ssd", "6", RKLT_CFG, None),
    "subgrid": ("grid", "ssd", "8", SUB_CFG, None),
}
GRID_SAMPLE = {"rklt_ssd_6": 3, "subgrid": 4}   # minimal samples (DOF)
# the LK fleets here; the grids in `test_torch_ssm_grid.py`
LK_FLEETS = [k for k in FLEETS if k not in GRID_SAMPLE]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU runs beside XLA's thread pool: one PyTorch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    """The LK fleets' JAX references, computed side by side first."""
    prepare_jax_runs()
    side_by_side([functools.partial(_jax_run, name)
                  for name in LK_FLEETS if name != "fclk_ssd_6"]
                 + [lambda: (_jax_run("fclk_ssd_6"),
                             _jax_run("fclk_ssd_6_pallas"))])


def prepare_jax_runs():
    """Every fleet's frames and JAX tracker, built one after the other
    before `_jax_run`s run side by side (a Pallas fleet's run goes after
    its generic twin's in one call: it takes that fleet's compiled
    init)."""
    for name, (_, _, ssm, _, _) in FLEETS.items():
        _frames(ssm)
        _jfleet(name)


@functools.cache
def _frames(ssm_key):
    """A 3-frame synthetic sequence on the test scene, drawn with the
    fleet's SSM (seed 4, sigma 0.004), as numpy; rendered by the port
    (`test_torch_fleet.test_synthetic_frames_match` holds its renderer to
    the JAX package's), and fed to both packages."""
    frames, gt = tsynth.synthetic_sequence(
        _scene(), CORNERS, tget_ssm(ssm_key, device="cpu"), n_frames=3,
        sigma_scale=0.004, seed=4)
    return frames.numpy(), gt


@functools.cache
def _jfleet(name):
    key, am, ssm, cfg, pallas = FLEETS[name]
    return JFleet(jcreate(key, am, ssm, use_pallas=pallas, **cfg))


@functools.cache
def _jax_run(name):
    """The JAX fleet's init state and its corners after each of two
    updates, computed once; a Pallas fleet starts from its generic twin's
    init state (`jax_init`). A composite's init state gets a placeholder
    final-corner slot (RKLT.update never reads it), so both updates share
    one compiled step."""
    key, am, ssm, cfg, pallas = FLEETS[name]
    fl = _jfleet(name)
    frames, _ = _frames(ssm)
    st = jax_init(_jfleet(name.removesuffix("_pallas")), frames[0], CORNERS)
    out = {"state0": jax.tree.map(np.asarray, st), "corners": [],
           "states": []}
    if key == "rklt":
        st = JCompositeState(st.members, (np.zeros(CORNERS.shape,
                                                   np.float32),))
    for t in (1, 2):
        st = fl.update(st, frames[t])
        out["corners"].append(np.asarray(fl.corners(st)))
        out["states"].append(jax.tree.map(np.asarray, st))
    return out


def _port(name):
    key, am, ssm, cfg, _ = FLEETS[name]
    sm = tcreate(key, am, ssm, device="cpu", **cfg)
    if name in GRID_SAMPLE:
        grid = sm.grid_sm if key == "rklt" else sm
        use_indices(grid, jax_fit_indices(2, n_pts=grid.grid.grid_res ** 2,
                                          sample=GRID_SAMPLE[name]))
    return sm


@pytest.mark.parametrize("name", LK_FLEETS)
def test_fleet_matches_jax_per_frame(name):
    """Two updates from the same init, each within 0.05 px of the JAX
    package (its generic XLA path, or with `_pallas` its Pallas kernel in
    interpret mode)."""
    check_fleet(name)


def check_fleet(name):
    """The per-frame parity of the fleet `name` of FLEETS."""
    ref = _jax_run(name)
    frames, gt = _frames(FLEETS[name][2])
    fl = TrackerFleet(_port(name))
    st = fl.initialize(frames[0], CORNERS)
    for t in (1, 2):
        st = fl.update(st, frames[t])
        got = fl.corners(st).numpy()
        assert np.abs(got - ref["corners"][t - 1]).max() < CORNER_TOL, t
        err = np.linalg.norm(np.transpose(got, (0, 2, 1)) - gt[t], axis=-1)
        assert np.isfinite(err).all(), (t, err)


def test_fleet_runs_the_chain_kernel_at_s6(monkeypatch):
    """fclk on the affine SSM: 6 iterations, each one chain call with the
    6 affine generators."""
    calls = []
    real = tk.lk_fused_chain_raw

    def spy(window, M0, gens, ph, *a, **kw):
        calls.append((gens.shape[0], ph.shape[-1]))
        return real(window, M0, gens, ph, *a, **kw)

    monkeypatch.setattr(tk, "lk_fused_chain_raw", spy)
    frames, _ = _frames("6")
    sm = _port("fclk_ssd_6")
    sm.update(sm.initialize(frames[0], CORNERS), frames[1])
    assert calls == [(6, 2500)] * 6


def test_convert_round_trip_and_update_at_s6():
    """A JAX fclk/affine state after one update, converted, gives back
    every field and takes the JAX second update."""
    ref = _jax_run("fclk_ssd_6")
    jst = ref["states"][0]
    tst = convert.to_torch(jst, device="cpu")
    assert tst.ssm_state.shape == (3, 6) and tst.extra.J0.shape[-1] == 6
    back = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst), strict=True):
        np.testing.assert_array_equal(a, b)
    frames, _ = _frames("6")
    sm = _port("fclk_ssd_6")
    got = sm.corners(sm.update(tst, frames[2])).numpy()
    assert np.abs(got - ref["corners"][1]).max() < CORNER_TOL
