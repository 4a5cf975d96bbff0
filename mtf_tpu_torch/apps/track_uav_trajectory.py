"""trackUAVTrajectory analog: localize a UAV image stream in a map (port
of `mtf_tpu/apps/track_uav_trajectory.py`).

Reference: `Examples/cpp/trackUAVTrajectory.cc` (ReadMe.md:243): each
UAV camera frame is registered against a large map image; the per-frame
warp's center traces the UAV's trajectory.

Pipeline: locate the frame in the map by features (`track_markers.
_locate`), then refine the central region's placement with a template
tracker (esm/ncc/8 by default, any CLI pairs) started from that guess,
and keep the feature estimate where the refinement jumps by more than
`--reloc_err` px. Writes the trajectory as `frame x y` rows and the
per-frame corner file. The tracker runs on the card unless `--device`
names another device.

Usage:
    python -m mtf_tpu_torch.apps.track_uav_trajectory --map map.jpg \
        --seq uav_frames/ --out_dir log [sm esm am ncc ssm 8]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map", required=True, dest="map_img")
    p.add_argument("--seq", required=True)
    p.add_argument("--out_dir", default="log")
    p.add_argument("--detector", default="orb")
    p.add_argument("--reloc_err", type=float, default=30.0,
                   help="corner-jump threshold triggering re-localization")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args, extra = p.parse_known_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.apps.track_markers import _locate
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.sm.feature import FeatureParams
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.config import read_params
    from mtf_tpu_torch.utils.gt import write_corners_file
    from mtf_tpu_torch.utils.input import get_input, load_image

    dev = _device.resolve(args.device)
    cfg = read_params(None, extra)
    sm_key = str(cfg.pop("sm", "esm"))
    am_key = str(cfg.pop("am", "ncc"))
    ssm_key = str(cfg.pop("ssm", "8"))

    map_np = np.asarray(load_image(args.map_img), np.float32).squeeze()
    map_img = torch.as_tensor(map_np, device=dev)
    fprm = FeatureParams(detector=args.detector)
    ssm8 = get_ssm("8", device=dev)
    trk = create_tracker(sm_key, am_key, ssm_key, device=dev, **cfg)

    prev_corners = None
    traj, corners_log = [], []
    for t, frame in enumerate(get_input(args.seq)):
        fnp = np.asarray(frame, np.float32).squeeze()
        fh, fw = fnp.shape[:2]
        # the template: the central region of the UAV frame
        m = 0.2
        tmpl_corners = np.asarray(
            [[fw * m, fh * m], [fw * (1 - m), fh * m],
             [fw * (1 - m), fh * (1 - m)], [fw * m, fh * (1 - m)]],
            np.float32)
        # global localization by features (frame -> map homography)
        frame_box = _locate(fprm, fnp, map_np, ssm8)
        if frame_box is None and prev_corners is None:
            traj.append((t + 1, np.nan, np.nan))
            continue
        if frame_box is not None:
            H = W.homography_dlt(
                torch.tensor([[0, 0], [fw - 1, 0], [fw - 1, fh - 1],
                              [0, fh - 1]], dtype=torch.float32, device=dev),
                torch.as_tensor(frame_box, device=dev))
            guess = W.apply_warp(H, torch.as_tensor(tmpl_corners,
                                                    device=dev)).cpu().numpy()
        else:
            guess = prev_corners
        # direct refinement: the template from the UAV frame, registered
        # against the map from the feature guess
        st = trk.initialize(torch.as_tensor(fnp, device=dev),
                            tmpl_corners[None])
        st = trk.set_region(st, torch.as_tensor(guess, device=dev)[None])
        st = trk.update(st, map_img)
        out = trk.corners(st)[0].T.cpu().numpy()
        if prev_corners is not None and np.linalg.norm(
                out - guess, axis=-1).mean() > args.reloc_err:
            out = guess  # the refinement diverged: keep the feature guess
        prev_corners = out
        corners_log.append(out)
        center = out.mean(axis=0)
        traj.append((t + 1, float(center[0]), float(center[1])))

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "uav_trajectory.txt"), "w") as f:
        f.write("frame x y\n")
        for fr, x, y in traj:
            f.write(f"{fr} {x:.3f} {y:.3f}\n")
    if corners_log:
        write_corners_file(os.path.join(args.out_dir, "uav_corners.txt"),
                           np.stack(corners_log))
    print(f"trajectory of {len(traj)} frames -> "
          f"{args.out_dir}/uav_trajectory.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
