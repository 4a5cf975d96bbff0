"""Port parity of the user entry points: `mtf_tpu_torch.apps.run_mtf` (the
single-object protocol on a synthetic sequence and on a PNG directory with
OptGT, the `--n_objs` fleet under the three protocols, `--multi`),
`eval_suite`, and the pyMTF, pyMTF2 and mex APIs, each held against the
JAX package on the same inputs. Every `main` is called in-process; the
JAX references are computed once per module, side by side on threads
(`test_torch_fleet.side_by_side`). Summaries agree in frames and failures
exactly and in errors within 0.05 px; the artifacts agree in format, and
in value within 0.05 px."""
import os
import re

import numpy as np
import pytest
import torch

import mtf_tpu.api as japi
import mtf_tpu.api2 as japi2
from mtf_tpu.api_mex import mex as jmex
from mtf_tpu.apps import eval_suite as jeval_suite
from mtf_tpu.apps import run_mtf as jrun_mtf
from mtf_tpu.utils import gt as jgt
from mtf_tpu_torch import api, api2, api_mex
from mtf_tpu_torch.apps import eval_suite, run_mtf
from mtf_tpu_torch.utils import gt
from test_torch_fleet import side_by_side

TOL_PX = 0.05
SMALL = ["sm", "fclk", "am", "ssd", "ssm", "2", "resx", "16", "resy", "16"]
SYN = ["--synthetic", "--n_frames", "6"]
PROTOCOLS = ("--reinit_on_failure", "--reinit_at_each_frame",
             "--reset_at_each_frame")
MULTI_CFG = """
mtf_sm\tfclk
mtf_am\tssd
mtf_ssm\t2

mtf_sm\tesm
mtf_am\tncc
mtf_ssm\t2
max_iters\t12
"""
API_CFG = dict(sm="fclk", am="ssd", ssm="2", resx=24, resy=24)


def _png_sequence(root):
    """A 6-frame 96x128 PNG sequence of a translating region and its MTF
    GT file, rendered by the port's synth on the CPU."""
    import cv2

    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    from test_torch_fleet import _scene
    box = np.array([[40.3, 30.6], [88.2, 31.1], [87.7, 70.4], [40.9, 69.8]],
                   np.float32)
    frames, g = synthetic_sequence(_scene(2, 96, 128), box,
                                   get_ssm("8", device="cpu"), n_frames=6,
                                   sigma_scale=0.01, seed=4)
    seq = os.path.join(root, "pngseq")
    os.makedirs(seq, exist_ok=True)
    for t, f in enumerate(frames.numpy()):
        cv2.imwrite(os.path.join(seq, f"frame{t + 1:05d}.png"),
                    np.clip(np.rint(f), 0, 255).astype(np.uint8))
    gt.write_corners_file(os.path.join(root, "pngseq.txt"), g)
    return seq, os.path.join(root, "pngseq.txt")


def _runs(root):
    """{name: argv} of every run_mtf case; each writes to its own dir."""
    seq, gt_path = _png_sequence(root)
    multi = os.path.join(root, "multi.cfg")
    with open(multi, "w") as f:
        f.write(MULTI_CFG)
    runs = {"synthetic": SYN + SMALL,
            "png": ["--seq", seq, "--gt", gt_path, "--reinit_on_failure",
                    "--use_opt_gt"] + SMALL,
            "multi": SYN + ["--multi", multi, "resx", "16", "resy", "16"]}
    for p in PROTOCOLS:
        runs["fleet" + p] = SYN + ["--n_objs", "4", p] + SMALL
    return {k: v + ["--write_outputs", "--out_dir", os.path.join(root, k)]
            for k, v in runs.items()}, seq


def _api_drive(mods, frame, shifted, seq):
    """pyMTF on (frame, shifted); pyMTF2 (2 trackers, 3 steps) and a mex
    round trip on the PNG sequence -> {name: corners}."""
    a, a2, mx = mods
    out = {}
    c = np.array([[40, 104, 104, 40], [30, 30, 94, 94]], np.float32)
    tid = a.create(frame, c, **API_CFG)
    out["api"] = a.getRegion(shifted, tid)
    a.setRegion(c + 1.0, tid)
    out["api_set"] = a.getRegion(shifted, tid)
    a.remove(tid)
    assert tid not in a.getTrackerIds()
    a2.init(seq)
    g0 = jgt.read_corners_file(seq + ".txt")[0].T
    ids = a2.createTrackers([g0, g0 + 0.5], **API_CFG)
    got = []
    for _ in range(3):
        assert a2.step()
        got.append([a2.getRegion(i) for i in ids])
    a2.quit()
    out["api2"] = np.asarray(got)
    assert mx("init", seq)[0]
    ok, mid = mx("create_tracker", g0, *[x for kv in API_CFG.items()
                                         for x in kv])
    ok2, region = mx("get_region", mid)
    assert ok and ok2 and mx("quit")[0]
    out["mex"] = np.asarray(region)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's runs and API drives, computed side by side."""
    root = str(tmp_path_factory.mktemp("jax"))
    runs, seq = _runs(root)
    out = {"root": root, "seq": seq, "runs": runs, "ret": {}}

    def run(name):
        def go():
            out["ret"][name] = jrun_mtf.main(runs[name] + ["--platform",
                                                           "cpu"])
        return go

    def apis():
        from mtf_tpu.utils import synth
        import jax.numpy as jnp
        frame = _frame()
        wm = jnp.array([[1, 0, 1.5], [0, 1, -1.0], [0, 0, 1]], jnp.float32)
        shifted = np.asarray(synth.warp_image(jnp.asarray(frame), wm))
        out["frames"] = (frame, shifted)
        out["apis"] = _api_drive((japi, japi2, jmex), frame, shifted, seq)

    side_by_side([run(k) for k in runs] + [apis])
    return out


def _frame():
    from test_torch_fleet import _scene
    return _scene(3, 128, 160)


def _stats(path):
    """tracking_stats.txt's summary lines as dicts of their fields."""
    return [dict(re.findall(r"(\w+)=(\[[^\]]*\]|\S+)", line))
            for line in gt.read_tracking_stats(path)]


def _close_fields(got, want, label):
    assert got.keys() == want.keys(), label
    for k in got:
        if k in ("fps", "obj_fps"):
            continue
        if k in ("frames", "failures", "objs"):
            assert got[k] == want[k], (label, k)
        else:
            g = np.asarray(got[k].strip("[]").split(","), np.float64)
            w = np.asarray(want[k].strip("[]").split(","), np.float64)
            np.testing.assert_allclose(g, w, atol=TOL_PX, err_msg=label)


def _close_artifacts(dir_t, dir_j, label):
    files = sorted(os.listdir(dir_j))
    assert sorted(os.listdir(dir_t)) == files, label
    for f in files:
        pt, pj = os.path.join(dir_t, f), os.path.join(dir_j, f)
        if f.endswith(".txt") and f != "tracking_stats.txt":
            a, b = gt.read_corners_file(pt), gt.read_corners_file(pj)
            assert a.shape == b.shape, (label, f)
            np.testing.assert_allclose(a, b, atol=TOL_PX, err_msg=f)
        elif f.endswith(".err"):
            a, b = gt.read_errors_file(pt), gt.read_errors_file(pj)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, atol=TOL_PX, err_msg=f)
        elif f.endswith(".sr"):
            (ta, a), (tb, b) = gt.read_sr_file(pt), gt.read_sr_file(pj)
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_allclose(a, b, atol=TOL_PX, err_msg=f)
        elif f == "tracking_stats.txt":
            sa, sb = _stats(pt), _stats(pj)
            assert len(sa) == len(sb), label
            for x, y in zip(sa, sb):
                _close_fields(x, y, label)
        else:
            assert f.endswith(".png"), f                 # the curves


@pytest.mark.parametrize("name", ["synthetic", "png", "multi"]
                         + ["fleet" + p for p in PROTOCOLS])
def test_run_mtf_matches_jax(ref, name, tmp_path):
    root = str(tmp_path)
    runs, _ = _runs(root)
    got = run_mtf.main(runs[name] + ["--device", "cpu"])
    want = ref["ret"][name]
    if name == "multi":
        assert len(got) == len(want) == 2        # one line per block
        got_err, want_err = [g[1] for g in got], [w[1] for w in want]
    else:
        got_err, want_err = got[1], want[1]
    np.testing.assert_allclose(got_err, want_err, atol=TOL_PX)
    _close_artifacts(os.path.join(root, name),
                     os.path.join(ref["root"], name), name)
    state = run_mtf.LAST_RUN["state"]
    assert all(x.device.type == "cpu" for x in
               torch.utils._pytree.tree_leaves(state)
               if isinstance(x, torch.Tensor))


def test_run_mtf_fleet_agrees_with_single_runs():
    """Under each protocol the fleet's per-object errors are the single-
    object runs' (`run_single` on the same frames and each object's GT):
    the JAX package's own claim (`tests/test_fleet_protocol.py:30`); a
    threshold under the tracking noise fires the failure path (each
    object's skip window, its reinit written into its fleet rows)."""
    for proto in PROTOCOLS + ("--reinit_on_failure --reinit_err_thresh "
                              "1e-6 --reinit_frame_skip 2",):
        argv = SYN + ["--n_objs", "3"] + proto.split() + SMALL + [
            "--device", "cpu"]
        run_mtf.main(argv)
        fleet = run_mtf.LAST_RUN["errors"]
        args, extra = run_mtf.build_argparser().parse_known_args(argv)
        from mtf_tpu_torch import create_tracker
        from mtf_tpu_torch.utils.config import read_params
        cfg = read_params(None, extra)
        keys = tuple(str(cfg.pop(k)) for k in ("sm", "am", "ssm"))
        trk = create_tracker(*keys, device="cpu", **cfg)
        frames, g = run_mtf.synthetic_input(3, 6, cfg, keys[2], "cpu")
        frames = list(frames)
        for i in range(3):
            run_mtf.run_single(args, trk, frames, g[:, i], g[0, i],
                               "synthetic", keys)
            single = run_mtf.LAST_RUN["errors"]
            np.testing.assert_array_equal(np.isnan(single),
                                          np.isnan(fleet[:, i]))
            ok = ~np.isnan(single)
            np.testing.assert_allclose(single[ok], fleet[ok, i], atol=1e-5)


def test_run_mtf_needs_a_device():
    """Without `--device` the run goes to the card, and raises where there
    is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mtf.main(SYN + SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_suite.main(["--n_frames", "3"])


def test_eval_suite_matches_jax_configs(monkeypatch):
    """The port's suite runs the JAX suite's configurations under its
    budgets; fclk/ssd/2 and rklt/ncc/8 run here within them (the whole
    suite takes minutes on the CPU: MI and CCRE run under 1 frame/s)."""
    assert eval_suite.BUDGETS_PX == jeval_suite.BUDGETS_PX
    configs = eval_suite._configs()
    assert configs == jeval_suite._configs()
    monkeypatch.setattr(eval_suite, "_configs", lambda: [
        c for c in configs if c[0] in ("fclk/ssd/2", "rklt/ncc/8")])
    assert eval_suite.main(["--n_frames", "4", "--device", "cpu"]) == 0


def test_apis_match_jax(ref):
    frame, shifted = ref["frames"]
    seq = ref["seq"]
    got = _api_drive((_cpu(api), _cpu(api2), _cpu_mex()), frame, shifted,
                     seq)
    for k, want in ref["apis"].items():
        assert got[k].shape == np.asarray(want).shape, k
        np.testing.assert_allclose(got[k], want, atol=TOL_PX, err_msg=k)
    assert api2.reader() is None                 # closed by quit()


class _cpu:
    """A port API module whose trackers are made on the CPU."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if name in ("create", "createTracker", "createTrackers"):
            return lambda *a, **kw: fn(*a, device="cpu", **kw)
        return fn


def _cpu_mex():
    def mx(cmd, *args):
        if cmd == "create_tracker":
            args = args + ("device", "cpu")
        return api_mex.mex(cmd, *args)
    return mx


def test_api_create_from_a_config_dir(tmp_path):
    """ROADMAP Queue 3, item 15: pyMTF's `create` with a .cfg directory
    that names the tracker (`mtf_sm` ...). `read_params` aliases those keys
    to `sm`, `am`, `ssm`, and the JAX package hands them to
    `create_tracker` a second time, so its `create` raises `TypeError`;
    the port takes the tracker's keys from the directory, as pyMTF does,
    and builds it."""
    (tmp_path / "mtf.cfg").write_text("mtf_sm fclk\nmtf_am ssd\nmtf_ssm 2\n"
                                      "mtf_res 16\n")
    frame = _frame()
    c = np.array([[40, 104, 104, 40], [30, 30, 94, 94]], np.float32)
    with pytest.raises(TypeError, match="multiple values"):
        japi.create(frame, c, str(tmp_path))
    tid = api.create(frame, c, str(tmp_path), device="cpu")
    trk = api._registry[tid]["tracker"]
    assert (trk.name, trk.ssm.dof, trk.am.prm.resx) == ("fclk", 2, 16)
    np.testing.assert_allclose(api.getRegion(frame, tid), c, atol=TOL_PX)
    api.remove(tid)
