"""generateSyntheticSeq analog: render a synthetic warped sequence with
exact ground truth (port of `mtf_tpu/apps/generate_synthetic_seq.py`).

Reference: `Examples/cpp/generateSyntheticSeq.cc:86-160` (SSM
perturbations, ILM drift and Gaussian noise from a seed image, writing
frames and exact GT; the "Synthetic" dataset actor, datasets.h:836). The
warp trajectory is drawn from numpy's `default_rng(seed)` as in the JAX
package; the frames are rendered on the card unless `--device` names
another device.

Usage:
    python -m mtf_tpu_torch.apps.generate_synthetic_seq --image seed.jpg \
        --out_dir synth_seq --n_frames 100 --ssm 8 --sigma 0.02 \
        --noise_sigma 2.0 --gain_drift 0.001
Writes out_dir/frame%05d.jpg and out_dir/gt.txt in the reference GT
format (`frame ulx uly urx ury lrx lry llx lly`, objUtils.cc readGT).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", help="seed image (synthetic if omitted)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_frames", type=int, default=100)
    p.add_argument("--ssm", default="8")
    p.add_argument("--sigma", type=float, default=0.02)
    p.add_argument("--noise_sigma", type=float, default=0.0)
    p.add_argument("--gain_drift", type=float, default=0.0)
    p.add_argument("--bias_drift", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    import cv2

    from mtf_tpu_torch import _device
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth
    from mtf_tpu_torch.utils.gt import write_corners_file

    dev = _device.resolve(args.device)
    if args.image:
        from mtf_tpu_torch.utils.input import load_image
        img = load_image(args.image)
    else:
        rng = np.random.default_rng(args.seed)
        raw = np.cumsum(np.cumsum(rng.normal(0, 1, (480, 640)), 0), 1)
        img = (raw - raw.min()) / (raw.max() - raw.min()) * 255.0
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    cx, cy, s = w / 2, h / 2, min(h, w) / 4
    corners0 = np.asarray([[cx - s, cy - s], [cx + s, cy - s],
                           [cx + s, cy + s], [cx - s, cy + s]], np.float32)

    frames, gt = synth.synthetic_sequence(
        img, corners0, get_ssm(args.ssm, device=dev), args.n_frames,
        sigma_scale=args.sigma, seed=args.seed, noise_sigma=args.noise_sigma,
        gain_drift=args.gain_drift, bias_drift=args.bias_drift)

    os.makedirs(args.out_dir, exist_ok=True)
    for i, f in enumerate(frames.cpu().numpy()):
        cv2.imwrite(os.path.join(args.out_dir, f"frame{i + 1:05d}.jpg"),
                    np.clip(f, 0, 255).astype(np.uint8))
    write_corners_file(os.path.join(args.out_dir, "gt.txt"), gt)
    print(f"wrote {args.n_frames} frames + gt.txt to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
