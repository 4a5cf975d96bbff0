"""Port parity of the harness utilities (`mtf_tpu_torch/utils/`): config,
metrics, GT files, OptGT and ReinitGT, datasets, the input readers, viz,
checkpoints and profiling, and the factory's multi.cfg and options rule,
each held against the JAX package on the same inputs made with numpy from
a seed."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.factory import create_trackers_from_multi as jfrom_multi
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu.utils import config as jconfig
from mtf_tpu.utils import datasets as jdatasets
from mtf_tpu.utils import gt as jgt
from mtf_tpu.utils import input as jinput
from mtf_tpu.utils import metrics as jmetrics
from mtf_tpu.utils import viz as jviz
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.factory import create_trackers_from_multi
from mtf_tpu_torch.parallel import TrackerFleet
from mtf_tpu_torch.ssm import get_ssm
from mtf_tpu_torch.utils import checkpoint, config, datasets, gt, metrics
from mtf_tpu_torch.utils import input as tinput
from mtf_tpu_torch.utils import profiling, viz
from test_torch_fleet import CORNERS, _scene

# the cfg texts of tests/test_utils.py:15-40 and tests/test_config_parity.py
CFG_TEXT = """
# a comment
mtf_sm fclk
mtf_am ncc
mtf_res 40
epsilon 0.01
enable_lm true
pf_ssm_sigma 0.1,0.2,0.3
#disabled_key 5
"""
SIGMA_CFG = """
# homography presets
00:ssm_sigma\t0.015,0.01,0,0,0,0,0,0
01:ssm_sigma\t0.03,0.02,0,0,0,0,0,0
19:ssm_sigma\t1
"""
MULTI_CFG = """
# Tracker 1
mtf_sm\tfclk
mtf_am\tssd
mtf_ssm\t2

# Tracker 2
mtf_sm\tesm
mtf_am\tncc
mtf_ssm\t8
max_iters\t12
"""
METRIC_TOL = 1e-6
OPT_GT_TOL_PX = 1e-3


@pytest.mark.parametrize("text", [CFG_TEXT, SIGMA_CFG, MULTI_CFG],
                         ids=["cfg", "sigma", "multi"])
def test_config_parses_like_jax(text, tmp_path):
    assert config.parse_cfg_text(text) == jconfig.parse_cfg_text(text)
    assert config.read_multi_cfg(text) == jconfig.read_multi_cfg(text)
    (tmp_path / "mtf.cfg").write_text(text)
    (tmp_path / "sigma.cfg").write_text(SIGMA_CFG)
    cli = ["mtf_am", "mi", "resy", "25", "coarse_pt_iters", "4:6,2:3"]
    assert (config.read_params(str(tmp_path), cli)
            == jconfig.read_params(str(tmp_path), cli))
    assert config.parse_arg_pairs(cli) == jconfig.parse_arg_pairs(cli)
    presets = config.parse_cfg_text(SIGMA_CFG)
    assert (config.resolve_sigma_presets(presets, [0, 1])
            == jconfig.resolve_sigma_presets(presets, [0, 1]))
    with pytest.raises(ValueError, match="dangling"):
        config.parse_arg_pairs(["resx"])


def _quads(rng, n):
    """n random convex-ish quads (jittered squares), some overlapping."""
    base = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    out = []
    for _ in range(n):
        s = rng.uniform(10, 60)
        q = base * s + rng.uniform(0, 40, 2) + rng.normal(0, 0.08 * s,
                                                          (4, 2))
        out.append(q[::-1] if rng.uniform() < 0.3 else q)
    return np.asarray(out, np.float32)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    a, b = _quads(rng, 64), _quads(rng, 64)
    b[:8] = a[:8]                                     # identical pairs
    b[8:16] = a[8:16] + 200.0                         # disjoint pairs
    for kind in ("mcd", "cl", "jaccard"):
        got = metrics.tracking_errors(a, b, kind)
        want = jmetrics.tracking_errors(a, b, kind)
        np.testing.assert_allclose(got, want, atol=METRIC_TOL)
    errs = rng.exponential(3.0, 200)
    for got, want in zip(metrics.success_rate_curve(errs),
                         jmetrics.success_rate_curve(errs)):
        np.testing.assert_allclose(got, want, atol=METRIC_TOL)


def test_gt_files_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    corners = rng.uniform(0, 300, (7, 4, 2)).astype(np.float32)
    errs = np.where(rng.uniform(size=6) < 0.2, np.nan, rng.uniform(0, 5, 6))
    th, sr, _ = jmetrics.success_rate_curve(errs[np.isfinite(errs)])
    names = [f"frame{t + 1:05d}.png" for t in range(7)]
    for pkg, d in ((gt, tmp_path / "t"), (jgt, tmp_path / "j")):
        pkg.write_corners_file(str(d / "c.txt"), corners)
        pkg.write_corners_file(str(d / "n.txt"), corners, names)
        pkg.write_errors_file(str(d / "e.err"), errs)
        pkg.write_sr_file(str(d / "s.sr"), th, sr)
        pkg.append_tracking_stats(str(d / "tracking_stats.txt"), "a b=1")
        pkg.append_tracking_stats(str(d / "tracking_stats.txt"), "c d=2\n")
        pkg.write_reinit_gt(str(d / "r.bin"), corners)
    for f in ("c.txt", "n.txt", "e.err", "s.sr", "tracking_stats.txt",
              "r.bin"):
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f
    t = str(tmp_path / "t")
    np.testing.assert_array_equal(gt.read_corners_file(t + "/c.txt"),
                                  jgt.read_corners_file(t + "/c.txt"))
    np.testing.assert_allclose(gt.read_errors_file(t + "/e.err"), errs,
                               atol=1e-6)
    np.testing.assert_allclose(gt.read_sr_file(t + "/s.sr")[1], sr,
                               atol=1e-6)
    assert gt.read_tracking_stats(t + "/tracking_stats.txt") == [
        "a b=1", "c d=2"]


@pytest.mark.parametrize("key", ["2", "4", "6", "8"])
def test_optimize_gt_and_reinit_gt_match_jax(key, tmp_path):
    """OptGT within 1e-3 px of the JAX package's; a ReinitGT file written
    by either package reads back the same in the other."""
    rng = np.random.default_rng(int(key))
    base = np.array([[40, 30], [120, 34], [116, 100], [36, 96]], np.float32)
    h = np.eye(3) + rng.normal(0, 0.02, (6, 3, 3)) * [[1, 1, 30], [1, 1, 30],
                                                       [1e-3, 1e-3, 0]]
    pts = np.concatenate([base, np.ones((4, 1), np.float32)], -1)
    warped = np.einsum("tij,nj->tni", h, pts)
    gt_seq = (warped[..., :2] / warped[..., 2:]).astype(np.float32)
    gt_seq[0] = base
    got = gt.optimize_gt(gt_seq, get_ssm(key, device="cpu"))
    want = jgt.optimize_gt(gt_seq, jget_ssm(key))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < OPT_GT_TOL_PX
    rgt = (lambda r: got[r:] + r)
    gt.write_reinit_gt(str(tmp_path / "t.bin"), rgt)
    jgt.write_reinit_gt(str(tmp_path / "j.bin"), rgt)
    for r in (0, 2, 5):
        np.testing.assert_array_equal(
            gt.read_reinit_gt(str(tmp_path / "j.bin"), r),
            jgt.read_reinit_gt(str(tmp_path / "t.bin"), r))
    with pytest.raises(ValueError):
        gt.read_reinit_gt(str(tmp_path / "j.bin"), 6)


def test_datasets_match_jax():
    assert datasets.SEQUENCES == jdatasets.SEQUENCES
    assert datasets.ACTORS == jdatasets.ACTORS
    for actor in datasets.ACTORS:
        if datasets.SEQUENCES[actor]:
            assert (datasets.sequence_by_id(actor, 0)
                    == jdatasets.sequence_by_id(actor, 0))
    with pytest.raises(ValueError):
        datasets.sequence_names("nope")


def _png_dir(path, n=4, seed=7):
    import cv2
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for t in range(n):
        cv2.imwrite(os.path.join(path, f"frame{t + 1:05d}.png"),
                    rng.integers(0, 256, (24, 32), dtype=np.uint8))
    cv2.imwrite(os.path.join(path, "rgb.png"),
                rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    return path


def test_input_readers_match_jax(tmp_path):
    d = _png_dir(str(tmp_path / "seq"))
    got = list(tinput.get_input(d))
    want = list(jinput.get_input(d))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tinput.load_image(os.path.join(d, "rgb.png")),
        jinput.load_image(os.path.join(d, "rgb.png")))
    arr = [np.zeros((2, 3), np.float32)]
    assert len(tinput.ArrayInput(arr)) == 1
    assert isinstance(tinput.get_input("u0"), tinput.CameraInput)
    with pytest.raises(FileNotFoundError):
        tinput.get_input(str(tmp_path / "missing"))
    from mtf_tpu_torch.utils import native_input
    from mtf_tpu_torch.video_capture import VideoCapture
    if native_input.native_available():
        nat = list(native_input.NativeInput(d))
        np.testing.assert_array_equal(nat[0], want[0])
    cap = VideoCapture(d)
    ok, frame = cap.read()
    assert ok and frame.dtype == np.float32 and cap.isOpened()
    cap.release()


def test_viz_annotate_matches_jax():
    frame = _scene()[:120, :160]
    regions = CORNERS[:2] * 0.5
    got = viz.annotate(frame, regions, labels=["a", "b"], gt=regions[0])
    want = jviz.annotate(frame, regions, labels=["a", "b"], gt=regions[0])
    np.testing.assert_array_equal(got, want)
    rgb = np.stack([frame] * 3, -1)
    np.testing.assert_array_equal(viz.annotate(rgb, regions[0]),
                                  jviz.annotate(rgb, regions[0]))


def _fleet_and_frames():
    sm = tcreate("fclk", "ssd", "8", device="cpu", resx=16, resy=16,
                 max_iters=5, epsilon=0.0, interp="linear_mm", crop=64)
    frame = _scene()
    frames = [np.roll(frame, (t, t // 2), (0, 1)) for t in range(4)]
    return TrackerFleet(sm), frames


def test_checkpoint_round_trip_and_resume(tmp_path):
    fleet, frames = _fleet_and_frames()
    st = fleet.update(fleet.initialize(frames[0], CORNERS), frames[1])
    path = str(tmp_path / "ck" / "fleet.npz")
    checkpoint.save_fleet(path, st)
    meta = json.loads(open(path + ".tree").read())
    like = fleet.initialize(frames[0], CORNERS)
    back = checkpoint.load_fleet(path, like)
    leaves = torch.utils._pytree.tree_leaves
    assert meta["n_leaves"] == len([x for x in leaves(st) if x is not None])
    for a, b, ref in zip(leaves(st), leaves(back), leaves(like)):
        if a is None:
            assert b is None
            continue
        assert b.dtype == ref.dtype and b.device == ref.device
        assert torch.equal(a, b)
    a = fleet.update(st, frames[2])
    b = fleet.update(back, frames[2])
    for x, y in zip(leaves(a), leaves(b)):
        assert (x is None and y is None) or torch.equal(x, y)
    # a state of another batch does not fit the checkpoint
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, fleet.initialize(frames[0], CORNERS[:2]))
    # a state with None fields (the PF's) and a grid's 0-d CPU counter
    pf = tcreate("pf100", "ssd", "2", device="cpu", resx=12, resy=12)
    pst = pf.update(pf.initialize(frames[0], CORNERS[:1]), frames[1])
    checkpoint.save_state(str(tmp_path / "pf"), pst)
    pback = checkpoint.load_state(str(tmp_path / "pf"),
                                  pf.initialize(frames[0], CORNERS[:1]))
    assert torch.equal(pback.extra.particles, pst.extra.particles)


def test_profiler_and_trace(tmp_path):
    fleet, frames = _fleet_and_frames()
    st = fleet.initialize(frames[0], CORNERS)
    prof = profiling.Profiler()
    prof.init_timer()
    with prof.section("update", sync=st):
        st = fleet.update(st, frames[1])
    prof.record_event("stage_b")
    s = prof.summary()
    assert s["update"]["n"] == 1 and "stage_b" in s
    path = prof.write(str(tmp_path / "log" / "times.txt"))
    assert open(path).read().splitlines()[1].startswith("update n=1 ")
    with profiling.trace(str(tmp_path / "trace")) as d:
        with profiling.annotate("fleet_update"):
            fleet.update(st, frames[2])
    trace = open(os.path.join(d, "trace.json")).read()
    assert "fleet_update" in trace


def _same_tracker(t, j):
    assert type(t).__name__ == type(j).__name__
    assert (t.ssm.dof, t.am.prm.resx, t.prm.max_iters) == (
        j.ssm.dof, j.am.prm.resx, j.prm.max_iters)


def test_factory_multi_cfg_builds_like_jax(tmp_path):
    """multi.cfg blocks build the trackers the JAX factory builds, alone
    and as `casc` / `prl` members (from a path or the text); an option
    that neither factory reads is ignored; an option the JAX package
    reads and the port has not ported raises naming its ROADMAP item."""
    path = tmp_path / "multi.cfg"
    path.write_text(MULTI_CFG)
    got = create_trackers_from_multi(MULTI_CFG, device="cpu", resx=16,
                                     resy=16)
    want = jfrom_multi(MULTI_CFG, resx=16, resy=16)
    assert len(got) == len(want) == 2
    for t, j in zip(got, want):
        _same_tracker(t, j)
    for key in ("casc", "prl"):
        t = tcreate(key, "ssd", "8", device="cpu", multi_cfg=str(path),
                    resx=16, resy=16)
        j = jcreate(key, "ssd", "8", multi_cfg=str(path), resx=16, resy=16)
        assert len(t.members) == len(j.members) == 2
        for tm, jm in zip(t.members, j.members):
            _same_tracker(tm, jm)
    sm = tcreate("fclk", "ssd", "2", device="cpu", resx=16, resy=16,
                 syn_sigma=0.01, pre_proc_type="none", mtf_sm="fclk")
    _same_tracker(sm, jcreate("fclk", "ssd", "2", resx=16, resy=16,
                              syn_sigma=0.01))
    for opt in ({"crop_blocks": (2, 2)}, {"interp_bf16": True},
                {"interp_precision": "highest"}):
        t = tcreate("fclk", "ssd", "8", device="cpu", **opt)
        j = jcreate("fclk", "ssd", "8", **opt)
        for f in ("crop_blocks", "interp_bf16", "interp_precision"):
            assert getattr(t.prm, f) == getattr(j.prm, f), (opt, f)
    tcreate("fclk", "ssd", "8", device="cpu", interp_bf16=False)
