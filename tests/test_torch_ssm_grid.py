"""Port parity, slice 6's grids: RKLT on the affine SSM and the
sub-tracker grid (100 fclk/ssd translation sub-trackers per tracker,
fused by RANSAC on the homography) against the JAX package with its
RANSAC index draws, the conversion of their states, and the grfc
trackers that only the port seemed to lose. Configurations, JAX runs and
tolerances are `test_torch_ssm_fleet.py`'s.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.sm.core import image_corners
from mtf_tpu_torch.sm.grid import SubGridState, SubTrackerGrid
from mtf_tpu_torch.ssm import get_ssm as tget_ssm
from mtf_tpu_torch.utils import synth as tsynth
from test_torch_fleet import CORNER_TOL, CORNERS, side_by_side
from test_torch_grid import jax_fit_indices, use_indices
from test_torch_ssm_fleet import GRID_SAMPLE, _frames, _jax_run, _port, \
    check_fleet, prepare_jax_runs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU runs beside XLA's thread pool: one PyTorch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(_one_torch_thread):
    """The grids' and grfc's JAX references, computed side by side first."""
    prepare_jax_runs()
    side_by_side([functools.partial(_jax_run, name) for name in GRID_SAMPLE]
                 + [_grfc_leg])


@pytest.mark.parametrize("name", list(GRID_SAMPLE))
def test_grid_fleet_matches_jax_per_frame(name):
    """Two updates from the same init, each within 0.05 px of the JAX
    package's generic path, the port handed the JAX RANSAC draws."""
    check_fleet(name)


def test_convert_rklt_corners_through_the_refiners_ssm():
    """A JAX RKLT state straight from `initialize` has no final corners:
    the port fills them through the refiner's own SSM (here the affine),
    as the JAX composite does, not a fresh homography; without the
    tracker an RKLT state of another DOF cannot be read. An affine RKLT
    state after one update converts and comes back unchanged."""
    ref = _jax_run("rklt_ssd_6")
    sm = _port("rklt_ssd_6")
    tst = convert.to_torch(ref["state0"], device="cpu", sm=sm)
    np.testing.assert_allclose(tst.extra[0].numpy(), CORNERS, atol=1e-3)
    with pytest.raises(ValueError, match="sm="):
        convert.to_torch(ref["state0"], device="cpu")
    # a state after one update comes back field by field (the JAX key
    # aside). Its next update is not compared here: the JAX generic path's
    # J0 takes a one-sided derivative where a point sits exactly on an
    # integer and the port's dense rule takes 0 (ROADMAP Queue 3, item 2),
    # and RKLT's ESM refiner carries J0 across updates
    jst = ref["states"][0]
    back = convert.to_numpy(convert.to_torch(jst, device="cpu", sm=sm))

    def leaves(st):
        g, t = st.members
        ge = g.extra
        return (jax.tree.leaves((g.ssm_state, g.am_state, g.region))
                + [ge.templates, ge.offsets, ge.centers0, ge.inlier_mask]
                + jax.tree.leaves((t.ssm_state, t.am_state, t.region,
                                   t.extra)) + list(st.extra))

    for a, b in zip(leaves(back), leaves(jst), strict=True):
        np.testing.assert_array_equal(a, b)


def test_convert_sub_tracker_grid_state():
    """The JAX sub-grid state (P sub-tracker states vmapped per tracker)
    becomes one flat batch of B·P sub-trackers, comes back field by field,
    and takes the JAX second update."""
    ref = _jax_run("subgrid")
    jst = ref["states"][0]
    tst = convert.to_torch(jst, device="cpu")
    assert isinstance(tst.extra, SubGridState)
    assert tst.extra.sub_states.ssm_state.shape == (3 * 25, 2)
    back = convert.to_numpy(tst)
    je, be = jst.extra, back.extra
    for a, b in zip(jax.tree.leaves((back.ssm_state, back.am_state,
                                     back.region, be.sub_states,
                                     be.centers0, be.half_img,
                                     be.inlier_mask)),
                    jax.tree.leaves((jst.ssm_state, jst.am_state, jst.region,
                                     je.sub_states, je.centers0, je.half_img,
                                     je.inlier_mask)), strict=True):
        np.testing.assert_array_equal(a, b)
    sm = _port("subgrid")
    use_indices(sm, jax_fit_indices(2, n_pts=25)[1:])
    got = sm.corners(sm.update(tst, _frames("8")[0][2])).numpy()
    assert np.abs(got - ref["corners"][1]).max() < CORNER_TOL


def test_sub_tracker_grid_reseats_its_sub_trackers():
    """After an update every sub-tracker sits on the fitted warp: its
    centre is the parent warp's image of its patch centre."""
    frames, _ = _frames("8")
    sm = _port("subgrid")
    assert isinstance(sm, SubTrackerGrid)
    st = sm.update(sm.initialize(frames[0], CORNERS), frames[1])
    gs = st.extra
    want = W.apply_warp(st.region.norm_mat,
                        sm.ssm.warp_pts(st.ssm_state, gs.centers0))
    got = image_corners(sm.sub.ssm, gs.sub_states).reshape(3, 25, 4, 2)
    np.testing.assert_allclose(got.mean(-2).numpy(), want.numpy(), atol=1e-3)


# -- grfc: the trackers only the port seemed to lose ------------------------
# On the chip GT leg (B = 384, `chip_smoke.grid_family()["grfc"]`) the
# port lost 8 trackers and the JAX package on the CPU, with its own RANSAC
# draw, 6 of them. Handed the JAX draw, the port on the CPU loses the same
# 10 trackers over the whole leg as the JAX package does
# (scripts/port_grfc_same_draw.py), and one more, tracker 233, at the last
# frame, where the grid's RANSAC counts 72 inliers against JAX's 71. These
# two trackers are lost at the last frame in both packages alike.
GRFC_TRACKERS = [19, 158]


@functools.cache
def _grfc_leg():
    key, am, b, cfg, _ = cs.grid_family()["grfc"]
    corners = cs._corners(b)
    frames, gt = tsynth.synthetic_sequence(
        cs._scene(0), corners, tget_ssm("8", device="cpu"), n_frames=6,
        sigma_scale=0.004, seed=3)
    frames = frames.numpy()
    sub = corners[GRFC_TRACKERS]
    fl = JFleet(jcreate(key, am, "8", **cfg))
    st = fl.initialize(frames[0], sub)
    out = []
    for t in range(1, len(frames)):
        st = fl.update(st, frames[t])
        out.append(np.asarray(fl.corners(st)))
    return frames, gt[:, GRFC_TRACKERS], sub, out, cfg


def test_grfc_trackers_agree_with_jax_on_the_same_draw():
    """Given the JAX package's RANSAC draw, the port follows the JAX grfc
    within 0.05 px on every frame, and both lose these trackers (over
    1 px from the ground truth) at the last frame: a difference of draws,
    not of the port."""
    frames, gt, sub, want, cfg = _grfc_leg()
    sm = tcreate("grfc", "ssd", "8", device="cpu", **cfg)
    use_indices(sm.members[0], jax_fit_indices(len(frames) - 1))
    st = sm.initialize(frames[0], sub)
    for t in range(1, len(frames)):
        st = sm.update(st, frames[t])
        got = sm.corners(st).numpy()
        assert np.abs(got - want[t - 1]).max() < CORNER_TOL, t
    for c in (got, want[-1]):
        err = np.linalg.norm(np.transpose(c, (0, 2, 1)) - gt[-1], axis=-1)
        assert (err.mean(-1) > 1.0).all(), err
