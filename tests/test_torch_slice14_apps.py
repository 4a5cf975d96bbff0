"""Port parity of slice 14's surfaces: `mtf_tpu_torch.diagnostics` and
`apps/diagnose`, the shared-memory `bridge` and `apps/tracker_node`,
`apps/parity_cv2`, `register_seq`, `create_mosaic`,
`generate_synthetic_seq`, `extract_patch`, `show_ground_truth`,
`record_seq`, `track_markers`, `track_uav_trajectory` and the three
examples, each held against the JAX package on the same inputs.

The port's `main`s run in-process, the tracker nodes in a process each
(the JAX node and the port's side by side on their own bridges), and the
JAX references in a pool of spawned processes, started when the module's
first test starts (`test_torch_cf.submit`'s pattern). The JAX
`track_markers` and `track_uav_trajectory` raise (reference fault 16,
`test_torch_feature_cmt.py`): they run here with `_locate` mended. Every
image an app writes is also kept as the array it handed `cv2.imwrite`,
and those arrays are compared (a JPEG's codec moves a one-level
difference further): within 1.0 of 0-255 each pixel, `show_ground_truth`
and `record_seq` exactly. Corners agree within 0.05 px; the diagnostics
agree in `ok` and each error within the JAX `prec`."""
import atexit
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from mtf_tpu.am import AMParams as JAMParams
from mtf_tpu.am import get_am as jget_am
from mtf_tpu.diagnostics import Diagnostics as JDiagnostics
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch.am import AMParams, get_am
from mtf_tpu_torch.diagnostics import Diagnostics
from mtf_tpu_torch.ssm import get_ssm
from mtf_tpu_torch.utils import gt as tgt
from test_torch_feature_cmt import blob_scene, jax_locate_mended
from test_torch_fleet import _scene

TOL_PX = 0.05
TOL_IMG = 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["resx", "16", "resy", "16", "max_iters", "10"]
NODE_PAIRS = ["sm", "fclk", "am", "ssd", "ssm", "8"] + SMALL
NODE_FRAMES = 4
DIAG_IMG = (96, 128)
DIAG_PAIRS = (("ncc", "8"),)


def _recording_imwrite(real=cv2.imwrite):
    """cv2.imwrite that also keeps the array it writes as `<path>.npy`."""
    def imwrite(path, img, *args):
        np.save(path + ".npy", img)
        return real(path, img, *args)
    return imwrite


def _same_images(a, b, tol=TOL_IMG, exact=False):
    """The images two runs wrote into dirs a and b (each file read back,
    each array it was written from compared)."""
    fa = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    assert fa == sorted(f for f in os.listdir(b) if f.endswith(".npy")) \
        and fa, (a, b)
    for f in fa:
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        assert x.shape == y.shape, f
        d = np.abs(x.astype(np.float64) - y).max()
        assert (d == 0) if exact else (d <= tol), (f, d)
        assert cv2.imread(os.path.join(b, f[:-4])) is not None, f


def _same_corners(a, b):
    x, y = tgt.read_corners_file(a), tgt.read_corners_file(b)
    assert x.shape == y.shape and len(x)
    assert np.abs(x - y).max() <= TOL_PX


def _mended(monkeypatch):
    """The JAX apps' `_locate` with the `_make_detector` call mended."""
    from mtf_tpu.apps import track_markers as jtm
    monkeypatch.setattr(jtm, "_locate", jax_locate_mended)


# -- the inputs ---------------------------------------------------------------

def _write_png_seq(root, name, frames):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for t, f in enumerate(frames):
        cv2.imwrite(os.path.join(d, f"frame{t + 1:05d}.png"),
                    np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return d


def _write_inputs(r):
    """The apps' inputs under r: the generated sequence (the JAX app's, 6
    frames of a 96x128 seed image); a 320x400 blob scene under 3 small
    affine motions and its marker, a 160x200 crop; a 320x400 blob map and
    2 UAV frames, 160x200 windows of it moving by (6, 4) px a frame."""
    from mtf_tpu.apps import generate_synthetic_seq as jgen
    cv2.imwrite(os.path.join(r, "seed.png"),
                _scene(3, 96, 128).astype(np.uint8))
    jgen.main(["--image", os.path.join(r, "seed.png"), "--out_dir",
               os.path.join(r, "seq"), "--n_frames", "6", "--sigma", "0.01",
               "--seed", "2"])
    # the init region off the pixel grid for the trackers (both packages'
    # samplers part at integer coordinates: ROADMAP Queue 3, item 2)
    g = tgt.read_corners_file(os.path.join(r, "seq", "gt.txt"))
    tgt.write_corners_file(os.path.join(r, "gt_off.txt"),
                           g + np.float32([0.37, 0.22]))
    scene = blob_scene(320, 400, 600, seed=2)
    cv2.imwrite(os.path.join(r, "marker.png"), scene[60:220, 80:280]
                .astype(np.uint8))
    frames = []
    for t in range(3):
        m = np.float32([[1 + 0.01 * t, 0.004 * t, 3.0 * t],
                        [-0.003 * t, 1 - 0.006 * t, 2.0 * t]])
        frames.append(cv2.warpAffine(scene, m, (400, 320),
                                     flags=cv2.INTER_LINEAR))
    _write_png_seq(r, "markerseq", frames)
    scene = blob_scene(320, 400, 600, seed=5)
    cv2.imwrite(os.path.join(r, "map.png"), scene.astype(np.uint8))
    _write_png_seq(r, "uavseq", [scene[60 + 4 * t:220 + 4 * t,
                                       90 + 6 * t:290 + 6 * t]
                                 for t in range(2)])


def _apps(r):
    """{name: (JAX main, port main, argv with {out} for the output)}."""
    from mtf_tpu.apps import (create_mosaic, extract_patch,
                              generate_synthetic_seq, record_seq,
                              register_seq, show_ground_truth,
                              track_markers, track_uav_trajectory)
    from mtf_tpu_torch.apps import create_mosaic as t_create_mosaic
    from mtf_tpu_torch.apps import extract_patch as t_extract_patch
    from mtf_tpu_torch.apps import generate_synthetic_seq as t_gen
    from mtf_tpu_torch.apps import record_seq as t_record_seq
    from mtf_tpu_torch.apps import register_seq as t_register_seq
    from mtf_tpu_torch.apps import show_ground_truth as t_show
    from mtf_tpu_torch.apps import track_markers as t_markers
    from mtf_tpu_torch.apps import track_uav_trajectory as t_uav
    seq, gt = os.path.join(r, "seq"), os.path.join(r, "seq", "gt.txt")
    mseq, marker = os.path.join(r, "markerseq"), os.path.join(r, "marker.png")
    useq, map_img = os.path.join(r, "uavseq"), os.path.join(r, "map.png")
    return {
        "generate_synthetic_seq": (
            generate_synthetic_seq.main, t_gen.main,
            ["--image", os.path.join(r, "seed.png"), "--out_dir", "{out}",
             "--n_frames", "4", "--sigma", "0.02", "--noise_sigma", "1.0",
             "--gain_drift", "0.01", "--seed", "5"]),
        "extract_patch": (extract_patch.main, t_extract_patch.main,
                          ["--seq", seq, "--gt", gt, "--out_dir", "{out}",
                           "--resx", "24", "--resy", "20"]),
        "show_ground_truth": (show_ground_truth.main, t_show.main,
                              ["--seq", seq, "--gt", gt, "--out_dir",
                               "{out}"]),
        "record_seq": (record_seq.main, t_record_seq.main,
                       ["--source", seq, "--out_dir", "{out}",
                        "--n_frames", "4"]),
        "register_seq": (register_seq.main, t_register_seq.main,
                         ["--seq", seq, "--gt", os.path.join(r, "gt_off.txt"),
                          "--out_dir", "{out}"] + SMALL),
        "create_mosaic": (create_mosaic.main, t_create_mosaic.main,
                          ["--seq", seq, "--out", "{out}/mosaic.png",
                           "--scale", "1.5"] + SMALL),
        "track_markers": (track_markers.main, t_markers.main,
                          ["--seq", mseq, "--markers", marker, "--out_dir",
                           "{out}"]),
        "track_uav_trajectory": (
            track_uav_trajectory.main, t_uav.main,
            ["--map", map_img, "--seq", useq, "--out_dir", "{out}"] + SMALL),
    }


def _argv(argv, out):
    return [a.replace("{out}", out) for a in argv]


_DIAG_IMG_SEED = 4


def _diag_inputs():
    img = _scene(_DIAG_IMG_SEED, *DIAG_IMG)
    h, w = DIAG_IMG
    s = min(h, w) / 4
    corners = np.float32([[w / 2 - s, h / 2 - s], [w / 2 + s, h / 2 - s],
                          [w / 2 + s, h / 2 + s], [w / 2 - s, h / 2 + s]])
    return img, corners


# -- the JAX references, in a pool of processes ----------------------------

REF_WORKERS = 3 if "PYTEST_XDIST_WORKER" in os.environ else 6
PARITY_FRAMES = 3        # the JAX rklt row: ~25 s to its first update,
                         # then ~3 s an update, op by op
_POOL = []


def _worker_init():
    # one thread a worker: the workers run side by side
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_"
                               "multi_thread_eigen=false intra_op_parallelism"
                               "_threads=1")
    torch.set_num_threads(1)
    import jax
    jax.config.update("jax_platforms", "cpu")
    cv2.imwrite = _recording_imwrite()


def jax_app(name, r):
    """The JAX app `name` on its inputs under r, its `_locate` mended;
    -> its exit code."""
    from mtf_tpu.apps import track_markers as jtm
    jtm._locate = jax_locate_mended
    jmain, _, argv = _apps(r)[name]
    return jmain(_argv(argv, os.path.join(r, "jax_" + name)))


def jax_diag(am, ssm):
    img, corners = _diag_inputs()
    dg = JDiagnostics(jget_am(am, JAMParams(resx=16, resy=16)),
                      jget_ssm(ssm))
    return dg.validate(img, corners, n_pts=5), dg.validate_chain(img, corners)


def jax_parity_row(i):
    """parity_cv2's row i on PARITY_FRAMES frames (each contender in its
    own job)."""
    from mtf_tpu.apps import parity_cv2
    return parity_cv2.head_to_head(
        n_frames=PARITY_FRAMES, contenders=[parity_cv2.CONTENDERS[i]])[0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this module, beside the JAX workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def root(tmp_path_factory):
    """The inputs, then every JAX reference submitted to the pool (the
    longest first), when the module's first test starts; -> (the
    directory, {job: future})."""
    r = str(tmp_path_factory.mktemp("slice14"))
    _write_inputs(r)
    pool = concurrent.futures.ProcessPoolExecutor(
        REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init)
    _POOL.append(pool)
    atexit.register(pool.shutdown, cancel_futures=True)
    jobs = {("parity", 4): (jax_parity_row, 4),
            "track_markers": (jax_app, "track_markers", r),
            "track_uav_trajectory": (jax_app, "track_uav_trajectory", r),
            ("parity", 1): (jax_parity_row, 1),
            **{("diag",) + p: (jax_diag,) + p for p in DIAG_PAIRS},
            ("parity", 2): (jax_parity_row, 2),
            **{n: (jax_app, n, r) for n in (
                "register_seq", "extract_patch", "create_mosaic",
                "generate_synthetic_seq", "show_ground_truth",
                "record_seq")},
            ("parity", 0): (jax_parity_row, 0),
            ("parity", 3): (jax_parity_row, 3)}
    return r, {k: pool.submit(*v) for k, v in jobs.items()}


@pytest.fixture
def ref(root):
    return _Results(root[1])


class _Results:
    """Futures read as a dict, each waited for when first read."""

    def __init__(self, futures):
        self.futures = futures

    def __getitem__(self, key):
        return self.futures[key].result()


@pytest.fixture(autouse=True)
def _record_port_writes(monkeypatch):
    monkeypatch.setattr(cv2, "imwrite", _recording_imwrite(cv2.imwrite))


# -- the examples ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["simple_tracking_demo",
                                  "composite_tracking_demo", "warping_demo"])
def test_example_exits_0(tmp_path, monkeypatch, name):
    """Each demo exits 0 in a fresh directory, writing there."""
    import importlib
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"mtf_tpu_torch.examples.{name}")
    argv = ["--device", "cpu"] + (["--ssms", "2,8", "--n", "3"]
                                  if name == "warping_demo" else [])
    assert mod.main(argv) == 0
    if name == "warping_demo":
        assert sorted(f for f in os.listdir(tmp_path / "log" /
                                            "warping_demo")
                      if f.endswith(".png")) == ["warps_2.png", "warps_8.png"]
    else:
        errs = (mod.LAST_ERRORS if name == "simple_tracking_demo"
                else sum(mod.LAST_ERRORS.values(), []))
        assert errs and max(errs) < 0.2


# -- diagnostics ---------------------------------------------------------------

def test_diagnose_cli(tmp_path):
    """`diagnose --validate` and `--validate_chain` exit 0 on OK, and
    write the curves; a sweep prints and plots."""
    from mtf_tpu_torch.apps import diagnose
    out = str(tmp_path / "log")
    base = ["--am", "ncc", "--ssm", "8", "--resx", "12", "--resy", "12",
            "--device", "cpu", "--out_dir", out]
    assert diagnose.main(base + ["--validate", "--n_pts", "5"]) == 0
    assert len([f for f in os.listdir(out) if f.endswith(".txt")]) == 8
    assert diagnose.main(base + ["--validate_chain"]) == 0
    assert diagnose.main(base + ["--n_pts", "5", "--data_type", "likelihood",
                                 "--plot"]) == 0
    assert os.path.exists(os.path.join(out, "diag_ncc_8.png"))


# -- the bridge and the tracker node -------------------------------------------

def test_bridge_round_trip_between_packages():
    """Frames written by one package's writer read back bit-exact by the
    other's reader, the ring wrapping past its slots."""
    from mtf_tpu import bridge as jbridge
    from mtf_tpu_torch import bridge as tbridge
    rng = np.random.default_rng(0)
    for wmod, rmod in ((jbridge, tbridge), (tbridge, jbridge)):
        name = f"t14_{os.getpid()}_{wmod.__name__.split('.')[0]}"
        w = wmod.SharedImageWriter(name, 12, 16, 1, n_slots=2)
        try:
            r = rmod.SharedImageReader(name)
            assert r.read_latest() == (None, None)
            for i in range(5):
                f = rng.uniform(0, 255, (12, 16)).astype(np.float32)
                assert w.write(f) == i
                fid, got = r.wait_next(timeout=1.0)
                assert fid == i
                np.testing.assert_array_equal(got[..., 0], f)
            r.close()
        finally:
            w.close()


def _node(module, name, corners, device_args):
    return subprocess.Popen(
        [sys.executable, "-m", module, "--bridge", name, "--corners",
         ",".join(f"{v:.3f}" for v in corners.reshape(-1)), "--n_frames",
         str(NODE_FRAMES - 1), "--timeout", "60"] + device_args + NODE_PAIRS,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})


NODE_BOX = np.float32([[40.3, 30.6], [88.2, 31.1], [87.7, 70.4],
                       [40.9, 69.8]])


def _node_frames():
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    frames, _ = synthetic_sequence(_scene(2, 96, 128), NODE_BOX,
                                   get_ssm("8", device="cpu"),
                                   n_frames=NODE_FRAMES, sigma_scale=0.01,
                                   seed=4)
    return frames.numpy()


@pytest.fixture(scope="module", autouse=True)
def nodes():
    """The JAX node and the port's, each a process on its own bridge with
    the first frame written, started with the module (their imports and
    the JAX node's compile run beside the other tests); -> ({package:
    writer}, {package: process}, the frames)."""
    from mtf_tpu_torch.bridge import SharedImageWriter
    frames = _node_frames()
    tag = f"t14n_{os.getpid()}"
    writers, procs = {}, {}
    try:
        for pkg, module, dev in (("jax", "mtf_tpu.apps.tracker_node",
                                  ["--platform", "cpu"]),
                                 ("port", "mtf_tpu_torch.apps.tracker_node",
                                  ["--device", "cpu"])):
            writers[pkg] = SharedImageWriter(f"{tag}_{pkg}", 96, 128, 1)
            writers[pkg].write(frames[0])
            procs[pkg] = _node(module, f"{tag}_{pkg}", NODE_BOX, dev)
        yield writers, procs, frames
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for w in writers.values():
            w.close()


def test_tracker_node_over_the_bridge(nodes):
    """The port's node against the JAX node, fed the same frames one at a
    time (the next frame written after the node's line for the last):
    corners within 0.05 px."""
    writers, procs, frames = nodes
    for pkg, p in procs.items():
        line = p.stdout.readline()
        assert json.loads(line) == {"event": "initialized", "frame": 0}, \
            (pkg, line, p.stderr.read() if p.poll() is not None else "")
    got = {pkg: [] for pkg in procs}
    for t in range(1, NODE_FRAMES):
        for pkg in procs:
            writers[pkg].write(frames[t])
        for pkg, p in procs.items():
            rec = json.loads(p.stdout.readline())
            assert rec["frame"] == t
            got[pkg].append(rec["corners"])
    for pkg, p in procs.items():
        assert p.wait(timeout=60) == 0, p.stderr.read()
    assert np.abs(np.asarray(got["port"]) - np.asarray(got["jax"])).max() \
        <= TOL_PX


@pytest.mark.parametrize("am,ssm", DIAG_PAIRS)
def test_diagnostics_validate(ref, am, ssm):
    img, corners = _diag_inputs()
    dg = Diagnostics(get_am(am, AMParams(resx=16, resy=16)),
                     get_ssm(ssm, device="cpu"))
    rep = dg.validate(img, corners, n_pts=5)
    want, want_chain = ref[("diag", am, ssm)]
    assert rep.ok == want.ok and rep.am == want.am and rep.ssm == want.ssm
    assert abs(rep.max_jac_err - want.max_jac_err) <= 2.5e-2
    assert abs(rep.max_hess_err - want.max_hess_err) <= 1e-1
    for d, (xs, ys) in rep.sweeps.items():
        np.testing.assert_allclose(ys, want.sweeps[d][1], rtol=1e-4,
                                   atol=1e-4)
    chain = dg.validate_chain(img, corners)
    assert chain["ok"] == want_chain["ok"]
    for k in ("std_jac_err", "esm_jac_err", "gn_hess_err", "hess_sym_err"):
        assert abs(chain[k] - want_chain[k]) <= 1e-2, k


# -- parity_cv2 ---------------------------------------------------------------

def test_parity_cv2(ref, capsys):
    """The port's rows against the JAX rows on the same frames; the CLI
    prints every row and verdict as JSON lines and exits 0 on parity."""
    from mtf_tpu_torch.apps import parity_cv2
    rows = parity_cv2.head_to_head(n_frames=PARITY_FRAMES, device="cpu")
    for i, r in enumerate(rows):
        w = ref[("parity", i)]
        assert (r["family"], r["tracker"]) == (w["family"], w["tracker"])
        assert "error" not in r, r
        assert abs(r["avg_mcd_px"] - w["avg_mcd_px"]) <= TOL_PX, (r, w)
        assert abs(r["max_mcd_px"] - w["max_mcd_px"]) <= TOL_PX, (r, w)
    assert all(v["parity"] for v in parity_cv2.verdicts(rows))
    assert parity_cv2.main(["--n_frames", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(rows) + 2
    assert all("family" in json.loads(x) for x in lines)


# -- the other apps -------------------------------------------------------------

CHECKS = {
    "generate_synthetic_seq": lambda j, t: (
        _same_images(j, t), _same_corners(os.path.join(j, "gt.txt"),
                                          os.path.join(t, "gt.txt"))),
    "extract_patch": lambda j, t: _same_images(j, t),
    "show_ground_truth": lambda j, t: _same_images(j, t, exact=True),
    "record_seq": lambda j, t: _same_images(j, t, exact=True),
    "register_seq": lambda j, t: _same_images(j, t),
    "create_mosaic": lambda j, t: _same_images(j, t),
    "track_markers": lambda j, t: _same_corners(
        os.path.join(j, "marker_marker.txt"),
        os.path.join(t, "marker_marker.txt")),
    "track_uav_trajectory": lambda j, t: (
        _same_corners(os.path.join(j, "uav_corners.txt"),
                      os.path.join(t, "uav_corners.txt")),
        _same_trajectory(os.path.join(j, "uav_trajectory.txt"),
                         os.path.join(t, "uav_trajectory.txt"))),
}


def _same_trajectory(a, b):
    x = np.loadtxt(a, skiprows=1)
    y = np.loadtxt(b, skiprows=1)
    assert x.shape == y.shape and np.isfinite(x).all()
    assert np.abs(x - y).max() <= TOL_PX


def jax_feat_draw(sm, step):
    """The RANSAC draw of the JAX feature tracker's update `step`: its
    key PRNGKey(seed) split once per update before."""
    import jax
    from mtf_tpu.ops import ransac as jransac
    key = jax.random.PRNGKey(sm.feat.seed)
    for _ in range(step + 1):
        key, k_fit = jax.random.split(key)
    return torch.as_tensor(np.asarray(jransac.hyp_indices(
        k_fit, sm.feat.n_hypotheses, sm.feat.max_keypoints,
        jransac.min_sample_size(sm.ssm))))


@pytest.mark.parametrize("name", list(CHECKS))
def test_app_against_jax(root, ref, name, monkeypatch):
    """Each app against the JAX app on the same inputs; the port's
    feature trackers take the JAX draws."""
    from mtf_tpu_torch.sm.feature import FeatureTracker
    monkeypatch.setattr(FeatureTracker, "hyp_draw", jax_feat_draw)
    r = root[0]
    _, tmain, argv = _apps(r)[name]
    out = os.path.join(r, "port_" + name)
    assert tmain(_argv(argv, out) + (
        [] if name in ("show_ground_truth", "record_seq")
        else ["--device", "cpu"])) == ref[name] == 0
    CHECKS[name](os.path.join(r, "jax_" + name), out)


def test_apps_need_the_card_by_default(root):
    """Without `--device` an app runs on the card, and raises here."""
    from mtf_tpu_torch.apps import extract_patch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_patch.main(["--seq", os.path.join(root[0], "seq"), "--gt",
                            os.path.join(root[0], "seq", "gt.txt")])
