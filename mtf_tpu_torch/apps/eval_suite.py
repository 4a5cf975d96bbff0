"""Milestone evaluation suite: BASELINE.md configs #1-#5 on synthetic GT
(port of `mtf_tpu/apps/eval_suite.py`, with the same configurations and
error budgets).

One command reproduces the accuracy story across the framework's
milestone configurations (BASELINE.json `configs`), each on a rendered
sequence with exact ground truth (the reference's Synthetic-actor
methodology, generateSyntheticSeq.cc):

  1. FCLK + SSD + 2-DOF translation
  2. ICLK/ESM + NCC + 8-DOF homography (+ pyramid)
  3. MI (+ CCRE) + Newton-flavor Hessians
  4. PF + NN stochastic search
  5. grid + RANSAC homography, RKLT

Prints one JSON line per config and a summary; exits non-zero if any
config misses its error budget.

The trackers run on the card unless `--device` names another device
(`--device cpu`).

Usage: python -m mtf_tpu_torch.apps.eval_suite [--n_frames 20] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

# budgets ~3-6x the observed errors (r3 run: fclk 0.014 max, mi 0.42,
# pf500 0.28, nn1k 2.05, ransac 0.65, rklt 0.011) so the suite actually
# regress-guards parity rather than merely passing
BUDGETS_PX = {
    "fclk/ssd/2": 0.25,
    "iclk/ncc/8": 0.5,
    "esm/ncc/8": 0.5,
    "pyr-esm/ncc/8": 0.5,
    "fclm/mi/8": 1.0,
    "fclm/ccre/8": 1.0,
    "pf500/ssd/2": 1.5,
    "nn1k/ssd/4": 2.5,
    # bare grid+RANSAC localization (chained-warp pyramidal patch flow);
    # RKLT refines it to ~0.01px
    "ransac/ssd/8": 1.5,
    "rklt/ncc/8": 0.5,
}


def _configs():
    return [
        ("fclk/ssd/2", ("fclk", "ssd", "2"), {}),
        ("iclk/ncc/8", ("iclk", "ncc", "8"), {}),
        ("esm/ncc/8", ("esm", "ncc", "8"), {}),
        ("pyr-esm/ncc/8", ("pyr", "ncc", "8"), {"pyr_sm": "esm"}),
        ("fclm/mi/8", ("fclm", "mi", "8"), {"hess_type": "std"}),
        ("fclm/ccre/8", ("fclm", "ccre", "8"), {"hess_type": "std"}),
        ("pf500/ssd/2", ("pf500", "ssd", "2"), {}),
        ("nn1k/ssd/4", ("nn1k", "ssd", "4"), {"nn_max_iters": 5}),
        ("ransac/ssd/8", ("ransac", "ssd", "8"),
         {"grid_res": 8, "grid_pyramid_levels": 3, "grid_sub_iters": 15}),
        ("rklt/ncc/8", ("rklt", "ncc", "8"), {}),
    ]


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_frames", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma", type=float, default=0.015)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu)")
    args = p.parse_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth

    dev = _device.resolve(args.device)
    try:
        from scipy.ndimage import gaussian_filter
        rng = np.random.default_rng(args.seed)
        img = gaussian_filter(rng.standard_normal((240, 320)), 2.0)
    except ImportError:
        rng = np.random.default_rng(args.seed)
        img = np.cumsum(np.cumsum(rng.normal(0, 1, (240, 320)), 0), 1)
    img = ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)
    corners0 = np.asarray([[110, 70], [210, 70], [210, 170], [110, 170]],
                          np.float32)
    failures = []
    for name, (sm, am, ssm), cfg in _configs():
        gen_ssm = get_ssm(ssm if ssm in ("2", "4") else "8", device=dev)
        frames, gt = synth.synthetic_sequence(
            img, corners0, gen_ssm, args.n_frames,
            sigma_scale=args.sigma, seed=args.seed)
        trk = create_tracker(sm, am, ssm, device=dev, **cfg)
        init = np.asarray(gt[0], np.float32)[None]
        state = trk.initialize(frames[0], init)
        trk.update(state, frames[0])  # warm-up: the first call builds
        _sync(dev)
        errs = []
        t0 = time.perf_counter()
        for t in range(1, len(frames)):
            state = trk.update(state, frames[t])
            c = trk.corners(state)[0].cpu().numpy().T
            errs.append(float(np.linalg.norm(c - gt[t], axis=-1).mean()))
        _sync(dev)
        dt = time.perf_counter() - t0
        avg, worst = float(np.mean(errs)), float(np.max(errs))
        budget = BUDGETS_PX[name]
        ok = worst < budget
        if not ok:
            failures.append(name)
        print(json.dumps({"config": name, "avg_err_px": round(avg, 3),
                          "max_err_px": round(worst, 3),
                          "budget_px": budget,
                          "fps": round((len(frames) - 1) / dt, 1),
                          "ok": ok}))
    print(json.dumps({"suite": "milestones", "n_configs": len(_configs()),
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
