"""extractPatch analog: sample the GT region's patch in each frame of a
sequence (port of `mtf_tpu/apps/extract_patch.py`).

Reference: `Examples/cpp/extractPatch.cc` — write the resampled
(resx x resy) patch inside the GT region of each frame. The patches are
sampled on the card unless `--device` names another device.

Usage:
    python -m mtf_tpu_torch.apps.extract_patch --seq frames_dir \
        --gt gt.txt --out_dir patches --resx 50 --resy 50
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out_dir", default="patches")
    p.add_argument("--resx", type=int, default=50)
    p.add_argument("--resy", type=int, default=50)
    p.add_argument("--interp", default="linear")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    import cv2

    from mtf_tpu_torch import _device
    from mtf_tpu_torch.ops import interp
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.utils.gt import read_corners_file
    from mtf_tpu_torch.utils.input import get_input

    dev = _device.resolve(args.device)
    gt = read_corners_file(args.gt)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for i, frame in enumerate(get_input(args.seq)):
        if i >= len(gt):
            break
        grid = W.grid_from_corners(torch.as_tensor(gt[i], device=dev),
                                   args.resx, args.resy)
        f3 = torch.as_tensor(np.asarray(frame, np.float32), device=dev)
        patch = interp.sample(f3, grid, args.interp)
        img = patch.reshape(args.resy, args.resx, -1).cpu().numpy()
        cv2.imwrite(os.path.join(args.out_dir, f"patch{i + 1:05d}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8))
        n += 1
    print(f"extracted {n} patches -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
