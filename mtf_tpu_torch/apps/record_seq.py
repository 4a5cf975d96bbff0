"""recordSeq analog: record a frame source as an image-directory
sequence (port of `mtf_tpu/apps/record_seq.py`).

Reference: `Examples/cpp/recordSeq.cc` — capture frames (camera, video
or directory) and write them as a numbered sequence for later tracking
and evaluation. It reads through the port's `video_capture` on the host
and needs no device.

Usage:
    python -m mtf_tpu_torch.apps.record_seq --source cam:0 --out_dir seq \
        [--n_frames 100]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_frames", type=int, default=0, help="0 = all")
    args = p.parse_args(argv)

    import cv2

    from mtf_tpu_torch.video_capture import VideoCapture

    cap = VideoCapture(args.source)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok or (args.n_frames and n >= args.n_frames):
            break
        n += 1
        out = np.clip(np.asarray(frame).squeeze(), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(args.out_dir, f"frame{n:05d}.jpg"), out)
    cap.release()
    print(f"recorded {n} frames -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
