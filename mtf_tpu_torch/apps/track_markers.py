"""trackMarkers analog: multi-marker detection and tracking with the
feature tracker (port of `mtf_tpu/apps/track_markers.py`).

Reference: `Examples/cpp/trackMarkers.cc` (ReadMe.md:245-247): given
marker template images, locate each marker in the sequence by feature
matching and keep tracking it; writes one corner file per marker.
Detection runs on the host (OpenCV), matching and the robust fits on the
card unless `--device` names another device.

Usage:
    python -m mtf_tpu_torch.apps.track_markers --seq frames_dir \
        --markers m1.jpg m2.jpg --out_dir log [--detector orb]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _locate(prm, marker_img, frame, ssm, idx=None):
    """The marker's corners (4, 2) in `frame` by global feature matching
    and a RANSAC homography (256 hypotheses, 5-px inliers), or None.
    `prm`: FeatureParams; the detector takes `prm.max_keypoints`, the
    scene's a budget grown by the area ratio (else the global top-N cap
    can leave no keypoint inside the target). `idx`: the RANSAC draw
    (default: a generator seeded 0)."""
    from mtf_tpu_torch.ops import ransac
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.sm.core import seeded_generator
    from mtf_tpu_torch.sm.feature import (_descr_float, _make_detector,
                                          _match, _to_u8)

    dev = ssm.device
    det = _make_detector(prm.detector, prm.max_keypoints)
    area_ratio = (frame.shape[0] * frame.shape[1]) / max(
        marker_img.shape[0] * marker_img.shape[1], 1)
    det_scene = _make_detector(
        prm.detector, int(prm.max_keypoints * max(1.0, area_ratio)))
    k0, d0 = det.detectAndCompute(_to_u8(marker_img), None)
    k1, d1 = det_scene.detectAndCompute(_to_u8(frame), None)
    if d0 is None or d1 is None or len(k0) < 8 or len(k1) < 8:
        return None
    f0 = torch.as_tensor(_descr_float(d0), device=dev)
    f1 = torch.as_tensor(_descr_float(d1), device=dev)
    idx1, ok = _match(f0, f1, ratio=prm.ratio_thresh)
    ok = ok.cpu().numpy()
    if ok.sum() < prm.min_matches:
        return None
    p0 = np.asarray([k.pt for k in k0], np.float32)[ok]
    p1 = np.asarray([k.pt for k in k1], np.float32)[idx1.cpu().numpy()[ok]]
    h, w = marker_img.shape[:2]
    # marker coordinates in a unit-ish frame for the robust fit
    T = np.array([[w, 0, w / 2], [0, h, h / 2], [0, 0, 1]], np.float32)
    Tinv = torch.as_tensor(np.linalg.inv(T), device=dev)
    src = W.apply_warp(Tinv, torch.as_tensor(p0, device=dev))
    if idx is None:
        idx = ransac.hyp_indices(seeded_generator(0, 0, 0, dev), 256,
                                 len(p0), ransac.min_sample_size(ssm))
    state, _ = ransac.robust_fit(ssm, src[None],
                                 torch.as_tensor(p1, device=dev)[None],
                                 torch.as_tensor(idx, device=dev),
                                 inlier_thresh=5.0)
    corners_m = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1],
                              [0, h - 1]], dtype=torch.float32, device=dev)
    return ssm.warp_pts(state, W.apply_warp(Tinv, corners_m)[None])[0] \
        .cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", required=True)
    p.add_argument("--markers", nargs="+", required=True)
    p.add_argument("--out_dir", default="log")
    p.add_argument("--detector", default="orb")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args, _ = p.parse_known_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.sm.feature import FeatureParams
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.gt import write_corners_file
    from mtf_tpu_torch.utils.input import get_input, load_image

    dev = _device.resolve(args.device)
    markers = [load_image(m) for m in args.markers]
    fprm = FeatureParams(detector=args.detector)
    ssm = get_ssm("8", device=dev)

    trackers, corners_log = {}, {i: [] for i in range(len(markers))}
    for frame in get_input(args.seq):
        frame = np.asarray(frame, np.float32)
        frame_d = torch.as_tensor(frame, device=dev)
        for i, m in enumerate(markers):
            if i not in trackers:
                c = _locate(fprm, m, frame, ssm)
                if c is not None:
                    trk = create_tracker("feat", "ssd", "8", device=dev,
                                         feat_detector=args.detector)
                    trackers[i] = (trk, trk.initialize(frame_d, c[None]))
            else:
                trk, st = trackers[i]
                trackers[i] = (trk, trk.update(st, frame_d))
            if i in trackers:
                trk, st = trackers[i]
                corners_log[i].append(trk.corners(st)[0].T.cpu().numpy())

    os.makedirs(args.out_dir, exist_ok=True)
    for i, cs in corners_log.items():
        if cs:
            name = os.path.splitext(os.path.basename(args.markers[i]))[0]
            write_corners_file(
                os.path.join(args.out_dir, f"marker_{name}.txt"),
                np.stack(cs))
    print(f"tracked {len(trackers)}/{len(markers)} markers; corners in "
          f"{args.out_dir}/marker_*.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
