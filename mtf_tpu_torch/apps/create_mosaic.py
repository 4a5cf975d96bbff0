"""createMosaic analog: a mosaic from tracked inter-frame warps (port of
`mtf_tpu/apps/create_mosaic.py`).

Reference: `Examples/cpp/createMosaic.cc` (ReadMe.md:244): track the
registration between consecutive frames, compose the warps into each
frame's pose in mosaic coordinates, and paste each frame's new pixels
into one canvas. The tracker (esm/ncc/8 by default, any CLI pairs),
re-anchored on each frame, and the canvas sampling run on the card
unless `--device` names another device.

Usage:
    python -m mtf_tpu_torch.apps.create_mosaic --seq frames_dir \
        --out mosaic.jpg --scale 2.0 sm esm am ncc ssm 8
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def _sample_zero_border(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (N, C) of img (H, W, C) at pts (N, 2) with pixels
    outside the image read as 0 (the JAX package's "constant" border):
    the replicate-border sampler on the image padded by one zero pixel."""
    from mtf_tpu_torch.ops import interp
    padded = F.pad(img.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    return interp.sample(padded, pts + 1.0, "linear")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", required=True)
    p.add_argument("--out", default="mosaic.jpg")
    p.add_argument("--scale", type=float, default=2.0,
                   help="mosaic canvas = scale x frame size")
    p.add_argument("--margin", type=float, default=0.15,
                   help="inner-region margin used for tracking")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args, extra = p.parse_known_args(argv)

    import cv2

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.utils.config import read_params
    from mtf_tpu_torch.utils.input import get_input
    from mtf_tpu_torch.utils.synth import full_grid

    dev = _device.resolve(args.device)
    cfg = read_params(None, extra)
    frames = [torch.as_tensor(np.asarray(f, np.float32), device=dev)
              for f in get_input(args.seq)]
    h, w = frames[0].shape[:2]
    m = args.margin
    corners = torch.tensor([[w * m, h * m], [w * (1 - m), h * m],
                            [w * (1 - m), h * (1 - m)], [w * m, h * (1 - m)]],
                           device=dev)

    sm = str(cfg.pop("sm", cfg.pop("mtf_sm", "esm")))
    am = str(cfg.pop("am", cfg.pop("mtf_am", "ncc")))
    ssm = str(cfg.pop("ssm", cfg.pop("mtf_ssm", "8")))
    trk = create_tracker(sm, am, ssm, device=dev, **cfg)

    H, Wd = int(h * args.scale), int(w * args.scale)
    gray = frames[0].dim() == 2
    canvas = torch.zeros((H, Wd) + tuple(frames[0].shape[2:]), device=dev)
    weight = torch.zeros((H, Wd), device=dev)
    # frame -> mosaic, the first frame centered
    pose = torch.tensor([[1, 0, (Wd - w) / 2], [0, 1, (H - h) / 2],
                         [0, 0, 1]], dtype=torch.float32, device=dev)
    grid = full_grid(H, Wd, device=dev)

    def blend(frame, pose_mat):
        """`frame` sampled at each canvas pixel through `pose_mat`
        (frame -> mosaic), and the mask of the pixels inside it."""
        pts = W.apply_warp(torch.linalg.inv(pose_mat), grid)
        f3 = frame[..., None] if gray else frame
        v = _sample_zero_border(f3, pts).reshape(H, Wd, -1)
        inside = ((pts[:, 0] >= 0) & (pts[:, 0] <= w - 1)
                  & (pts[:, 1] >= 0) & (pts[:, 1] <= h - 1))
        return (v[..., 0] if gray else v), \
            inside.to(torch.float32).reshape(H, Wd)

    v, msk = blend(frames[0], pose)
    canvas += v * (msk if gray else msk[..., None])
    weight += msk

    state = trk.initialize(frames[0], corners[None])
    prev_corners = corners
    for f in frames[1:]:
        state = trk.update(state, f)
        cur = trk.corners(state)[0].T                  # (4, 2) in the frame
        # the inter-frame warp prev -> cur, composed into the running pose
        M = W.homography_dlt(prev_corners, cur)
        pose = pose @ torch.linalg.inv(M)
        v, msk = blend(f, pose)
        new = weight == 0
        canvas[new] = v[new]
        weight += msk
        # re-anchor the tracker on each frame (small inter-frame motion)
        state = trk.initialize(f, corners[None])
        prev_corners = corners

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cv2.imwrite(args.out, np.clip(canvas.cpu().numpy(), 0, 255)
                .astype(np.uint8))
    print(f"mosaic ({H}x{Wd}) written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
