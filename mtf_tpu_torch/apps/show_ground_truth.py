"""showGroundTruth analog: draw the GT regions onto the frames (port of
`mtf_tpu/apps/show_ground_truth.py`).

Reference: `Examples/cpp/showGroundTruth.cc` — draw each frame's GT
corner polygon over the sequence; headless here, it writes the annotated
frames. It draws with OpenCV on the host and needs no device.

Usage:
    python -m mtf_tpu_torch.apps.show_ground_truth --seq frames_dir \
        --gt gt.txt --out_dir annotated [--n_frames 50]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out_dir", default="annotated")
    p.add_argument("--n_frames", type=int, default=0)
    args = p.parse_args(argv)

    import cv2

    from mtf_tpu_torch.utils.gt import read_corners_file
    from mtf_tpu_torch.utils.input import get_input

    gt = read_corners_file(args.gt)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for i, frame in enumerate(get_input(args.seq)):
        if i >= len(gt) or (args.n_frames and i >= args.n_frames):
            break
        img = np.clip(np.asarray(frame), 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        cv2.polylines(img, [gt[i].astype(np.int32)], True, (0, 0, 255), 2)
        cv2.imwrite(os.path.join(args.out_dir, f"frame{i + 1:05d}.jpg"), img)
        n += 1
    print(f"annotated {n} frames -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
