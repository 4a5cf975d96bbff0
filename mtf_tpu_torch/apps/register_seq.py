"""registerSeq analog: whole-sequence registration / stabilization (port
of `mtf_tpu/apps/register_seq.py`).

Reference: `Examples/cpp/registerSeq.cc` — track a region through the
sequence, then render each frame warped by the inverse of its estimated
warp (registerSeq.cc:199-201) so that the tracked region stays fixed.
The tracker (esm/ncc/8 by default, any CLI pairs) and the rendering run
on the card unless `--device` names another device; each frame goes to
the card once.

Usage:
    python -m mtf_tpu_torch.apps.register_seq --seq frames_dir \
        --gt gt.txt --out_dir registered sm esm am ncc ssm 8
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", required=True)
    p.add_argument("--gt", help="GT file for the init region")
    p.add_argument("--out_dir", default="registered")
    p.add_argument("--interp", default="linear")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args, extra = p.parse_known_args(argv)

    import cv2

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.utils.config import read_params
    from mtf_tpu_torch.utils.gt import read_corners_file
    from mtf_tpu_torch.utils.input import get_input
    from mtf_tpu_torch.utils.synth import warp_image

    dev = _device.resolve(args.device)
    cfg = read_params(None, extra)
    frames = [torch.as_tensor(np.asarray(f, np.float32), device=dev)
              for f in get_input(args.seq)]
    if args.gt:
        corners0 = torch.as_tensor(read_corners_file(args.gt)[0], device=dev)
    else:
        h, w = frames[0].shape[:2]
        s = min(h, w) / 4
        corners0 = torch.tensor([[w / 2 - s, h / 2 - s],
                                 [w / 2 + s, h / 2 - s],
                                 [w / 2 + s, h / 2 + s],
                                 [w / 2 - s, h / 2 + s]], device=dev)

    sm = str(cfg.pop("sm", cfg.pop("mtf_sm", "esm")))
    am = str(cfg.pop("am", cfg.pop("mtf_am", "ncc")))
    ssm = str(cfg.pop("ssm", cfg.pop("mtf_ssm", "8")))
    trk = create_tracker(sm, am, ssm, device=dev, **cfg)
    state = trk.initialize(frames[0], corners0[None])

    os.makedirs(args.out_dir, exist_ok=True)

    def save(i, f):
        cv2.imwrite(os.path.join(args.out_dir, f"frame{i:05d}.jpg"),
                    np.clip(f.cpu().numpy(), 0, 255).astype(np.uint8))

    save(1, frames[0])
    for i, f in enumerate(frames[1:], start=2):
        state = trk.update(state, f)
        # the tracked region's template -> image warp: rendering with its
        # inverse pulls the region back to its initial place
        # (registerSeq.cc:199-201): out(x) = frame(M x)
        M = W.homography_dlt(corners0, trk.corners(state)[0].T)
        save(i, warp_image(f, torch.linalg.inv(M), args.interp))
    print(f"registered {len(frames)} frames -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
