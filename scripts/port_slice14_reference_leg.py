"""The JAX package's readings of the slice-14 legs that `chip_smoke.py`
runs on the card (`chip_smoke._slice14_phase`), on the CPU.

    python scripts/port_slice14_reference_leg.py [--keep DIR]

Prints `chip_smoke.SLICE14_JAX_READING`:
  - feat_gt_px, cmt_gt_px: the feature tracker (feat/ssd/8, ORB, with
    `chip_smoke.SLICE14_FEAT_CFG`) and CMT, one JAX tracker per box of
    `chip_smoke.slice14_corners()`, over the blob
    scene's 6-frame homography walk (`chip_smoke.slice14_gt_errors`'s
    frames, rendered by the port's synth on the CPU): the mean corner
    error over the trackers and the 5 updates;
  - parity: `mtf_tpu.apps.parity_cv2` at its defaults, each row's
    avg_mcd;
  - track_markers_px, track_uav_px: the JAX apps on
    `chip_smoke.slice14_marker_inputs` / `slice14_uav_inputs`, with
    `_locate`'s call to `_make_detector` mended (the JAX app raises
    TypeError otherwise: reference fault 16), their corners' mean distance
    from GT;
  - simple_demo_px, composite_demo_px: the root examples' printed mean
    errors.
`--keep DIR` writes the inputs under DIR and keeps them.
"""
import argparse
import contextlib
import io
import os
import re
import runpy
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mtf_tpu import create_tracker  # noqa: E402
from mtf_tpu.apps import parity_cv2  # noqa: E402
from mtf_tpu.apps import track_markers as jtm  # noqa: E402
from mtf_tpu.apps import track_uav_trajectory as juav  # noqa: E402
from mtf_tpu_torch.utils import gt as gtio  # noqa: E402
from test_torch_feature_cmt import jax_locate_mended  # noqa: E402


def gt_leg(key):
    """One JAX tracker per box over the GT leg's frames: the mean corner
    error over trackers and updates."""
    import torch  # noqa: F401  (the port's synth renders the frames)
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    corners = cs.slice14_corners()
    frames, gt = synthetic_sequence(cs.blob_scene(), corners,
                                    get_ssm("8", device="cpu"), n_frames=6,
                                    sigma_scale=0.004, seed=3)
    frames = frames.numpy()
    sm = create_tracker(key, "ssd", "8",
                        **(cs.SLICE14_FEAT_CFG if key == "feat" else {}))
    errs = []
    if key == "cmt":
        step = jax.jit(sm.update_with_detections)
    for b in range(len(corners)):
        st = sm.initialize(jnp.asarray(frames[0]), jnp.asarray(corners[b]))
        for t in range(1, len(frames)):
            if key == "cmt":
                # `CMT.update`: the frame's detections, padded, then the
                # device stage (jitted here)
                p = sm.prm
                pts, desc = sm._detect(frames[t])
                n = p.max_keypoints + p.max_bg
                pt_p, pt_v = sm._pad(pts, n, 2)
                de_p, _ = sm._pad(desc, n, st.kp_desc.shape[1])
                st = step(st, pt_p, de_p, pt_v, jnp.asarray(frames[t]))
            else:
                st = sm.update(st, jnp.asarray(frames[t]))
            c = np.asarray(sm.corners(st)).T
            errs.append(float(np.linalg.norm(c - gt[t, b], axis=-1).mean()))
    return float(np.mean(errs))


def apps(root):
    jtm._locate = jax_locate_mended
    seq, marker, mgt = cs.slice14_marker_inputs(root, "cpu")
    jtm.main(["--seq", seq, "--markers", marker, "--out_dir",
              os.path.join(root, "markers")])
    markers_px = cs.corner_error(gtio.read_corners_file(
        os.path.join(root, "markers", "marker_marker.txt")), mgt)
    map_path, useq, ugt = cs.slice14_uav_inputs(root)
    juav.main(["--map", map_path, "--seq", useq, "--out_dir",
               os.path.join(root, "uav"), "sm", "esm", "am", "ncc", "ssm",
               "8"] + cs.SLICE14_UAV_PAIRS)
    uav_px = cs.corner_error(gtio.read_corners_file(
        os.path.join(root, "uav", "uav_corners.txt")), ugt)
    return markers_px, uav_px


def example(name):
    """The root example's printed output."""
    argv = sys.argv
    sys.argv = [name]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]()
    finally:
        sys.argv = argv
    return buf.getvalue()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--keep", default=None)
    args = p.parse_args()
    root = args.keep or tempfile.mkdtemp()
    out = {}
    for key in ("feat", "cmt"):
        t0 = time.perf_counter()
        out[f"{key}_gt_px"] = gt_leg(key)
        print(f"{key}: {out[key + '_gt_px']} px "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    rows = parity_cv2.head_to_head()
    out["parity"] = {r["tracker"]: r["avg_mcd_px"] for r in rows}
    print(f"parity_cv2: {rows} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["track_markers_px"], out["track_uav_px"] = apps(root)
    print(f"apps: markers {out['track_markers_px']} px, uav "
          f"{out['track_uav_px']} px", flush=True)
    simple = example("simple_tracking_demo")
    out["simple_demo_px"] = float(np.mean(
        [float(x) for x in re.findall(r"err=([0-9.]+)px", simple)]))
    comp = example("composite_tracking_demo")
    out["composite_demo_px"] = {
        m.group(1): float(m.group(2)) for m in re.finditer(
            r"^(\S+)\s+mean MCD\s+([0-9.]+) px", comp, re.M)}
    print(simple + comp)
    print("SLICE14_JAX_READING = " + repr(out))
    return out


if __name__ == "__main__":
    main()
