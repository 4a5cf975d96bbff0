"""Head-to-head accuracy parity against independent implementations
(port of `mtf_tpu/apps/parity_cv2.py`).

OpenCV ships independent implementations of the two headline algorithm
families of the reference (ReadMe.md:430-438):

- ``cv2.findTransformECC`` — the Evangelidis & Psarakis ECC aligner, the
  same direct template-alignment problem FCLK and ESM solve, run here in
  ``MOTION_HOMOGRAPHY`` mode with warm-started warps (the tracking
  protocol of `runMTF.cc:499-599`);
- ``cv2.calcOpticalFlowPyrLK`` + ``cv2.findHomography(RANSAC)`` — the
  pyramidal KLT point flow and robust homography, the counterpart of the
  grid tracker and SSMEstimator (`GridTracker.cc`,
  `SSMEstimator.cc:73-130`).

Both contenders and the port's trackers run on the same rendered sequence
with exact ground truth (the generateSyntheticSeq protocol), and the
script prints a head-to-head mean-corner-distance table as JSON lines:
parity is the port's error at or below the independent implementation's
(+0.25 px) in each family. The port's trackers and the rendering run on
the card unless `--device` names another device; OpenCV runs on the host.

Usage: python -m mtf_tpu_torch.apps.parity_cv2 [--n_frames 20] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _textured_scene(seed=0, h=240, w=320):
    """Multi-scale textured scene (smooth plus mid-frequency detail, so
    that both the gradient aligners and the KLT corners have
    structure)."""
    import cv2
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    img = (img - img.min()) / (img.max() - img.min())
    fine = rng.normal(0, 1, (h // 4, w // 4))
    fine = cv2.resize(fine, (w, h), interpolation=cv2.INTER_CUBIC)
    fine = cv2.GaussianBlur(fine, (5, 5), 1.5)
    img = 0.7 * img + 0.3 * (fine - fine.min()) / (fine.max() - fine.min())
    return (img * 255.0).astype(np.float32)


def make_sequence(n_frames=20, seed=0, sigma_scale=0.015, noise_sigma=0.0,
                  device=None):
    """A rendered homography random walk with exact corner GT:
    (frames (T, H, W) on `device`, GT (T, 4, 2), the init corners)."""
    from mtf_tpu_torch import _device
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth

    corners0 = np.array([[110, 80], [210, 80], [210, 160], [110, 160]],
                        np.float32)
    frames, gt = synth.synthetic_sequence(
        _textured_scene(seed + 7), corners0,
        get_ssm("8", device=_device.resolve(device)), n_frames=n_frames,
        sigma_scale=sigma_scale, seed=seed, noise_sigma=noise_sigma)
    return frames, gt, corners0


def _mcd(c, gt_c):
    return float(np.mean(np.linalg.norm(
        np.asarray(c, np.float64) - np.asarray(gt_c, np.float64), axis=-1)))


# ---------------------------------------------------------------- ours

def run_ours(key3, frames, gt, **cfg):
    """Track with one of the port's SM(AM, SSM) programs on the frames'
    device; the per-frame MCD list."""
    from mtf_tpu_torch import create_tracker

    sm = create_tracker(*key3, device=frames.device, **cfg)
    state = sm.initialize(frames[0], np.asarray(gt[0])[None])
    errs = []
    for t in range(1, len(frames)):
        state = sm.update(state, frames[t])
        errs.append(_mcd(sm.corners(state)[0].T.cpu().numpy(), gt[t]))
    return errs


# -------------------------------------------------------- cv2 contenders

def run_cv2_ecc(frames, gt, max_iters=50, eps=1e-5):
    """cv2.findTransformECC MOTION_HOMOGRAPHY, warm-started per frame.
    The template is the initial region's crop; the recovered warp maps
    template-local coordinates to the frame's (the WARP_INVERSE_MAP
    convention), so the tracked corners are W @ (corners0 - crop
    origin)."""
    import cv2

    c0 = np.asarray(gt[0], np.float32)
    x0, y0 = np.floor(c0.min(axis=0)).astype(int)
    x1, y1 = np.ceil(c0.max(axis=0)).astype(int)
    template = np.ascontiguousarray(frames[0][y0:y1, x0:x1], np.float32)
    local = (c0 - np.array([x0, y0], np.float32)).reshape(-1, 1, 2)

    warp = np.eye(3, dtype=np.float32)
    warp[:2, 2] = (x0, y0)  # template-local -> image coords at t=0
    crit = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, max_iters, eps)
    errs = []
    for t in range(1, len(frames)):
        inp = np.ascontiguousarray(frames[t], np.float32)
        try:
            _, warp = cv2.findTransformECC(template, inp, warp,
                                           cv2.MOTION_HOMOGRAPHY, crit)
        except cv2.error:
            pass  # keep the previous warp (a failure on this frame)
        c = cv2.perspectiveTransform(local, warp).reshape(-1, 2)
        errs.append(_mcd(c, gt[t]))
    return errs


def run_cv2_klt(frames, gt, grid=8, win=21, levels=3):
    """Pyramidal KLT grid flow + RANSAC homography, frame to frame,
    chained against the init grid (the grid tracker's `warped` geometry
    with OpenCV's own pieces)."""
    import cv2

    c0 = np.asarray(gt[0], np.float32)
    xs = np.linspace(c0[:, 0].min() + 3, c0[:, 0].max() - 3, grid)
    ys = np.linspace(c0[:, 1].min() + 3, c0[:, 1].max() - 3, grid)
    pts0 = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 1, 2)
    pts0 = pts0.astype(np.float32)

    def to_u8(f):
        return np.clip(f, 0, 255).astype(np.uint8)

    prev = to_u8(frames[0])
    prev_pts = pts0.copy()
    lk = dict(winSize=(win, win), maxLevel=levels,
              criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                        30, 0.01))
    errs = []
    corners = c0.reshape(-1, 1, 2).copy()
    for t in range(1, len(frames)):
        cur = to_u8(frames[t])
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(prev, cur, prev_pts, None,
                                              **lk)
        ok = st.ravel() == 1
        if ok.sum() >= 8:
            H, _ = cv2.findHomography(pts0[ok], nxt[ok], cv2.RANSAC, 2.0)
            if H is not None:
                corners = cv2.perspectiveTransform(
                    c0.reshape(-1, 1, 2).astype(np.float64), H)
        errs.append(_mcd(corners.reshape(-1, 2), gt[t]))
        # failed points (st == 0) hold their last good position, so that
        # the contender is not handicapped against its usual use
        nxt = np.where(ok[:, None, None], nxt, prev_pts)
        prev, prev_pts = cur, nxt
    return errs


# ------------------------------------------------------------- protocol

# (family, name, runner (frames on the device, their host copy, GT)):
# each family pairs the port against the independent implementation of
# the same algorithm class
CONTENDERS = [
    ("direct-alignment", "opencv:ECC-homography",
     lambda fr, fr_np, gt: run_cv2_ecc(fr_np, gt)),
    ("direct-alignment", "mtf_tpu:esm/ncc/8",
     lambda fr, fr_np, gt: run_ours(("esm", "ncc", "8"), fr, gt, resx=50,
                                    resy=50, max_iters=30)),
    ("direct-alignment", "mtf_tpu:fclk/ssd/8",
     lambda fr, fr_np, gt: run_ours(("fclk", "ssd", "8"), fr, gt, resx=50,
                                    resy=50, max_iters=30)),
    ("grid-flow", "opencv:pyrLK+RANSAC",
     lambda fr, fr_np, gt: run_cv2_klt(fr_np, gt)),
    ("grid-flow", "mtf_tpu:rklt/ncc/8",
     lambda fr, fr_np, gt: run_ours(("rklt", "ncc", "8"), fr, gt)),
]


def head_to_head(n_frames=20, seed=0, sigma_scale=0.015, noise_sigma=0.0,
                 contenders=CONTENDERS, device=None):
    frames, gt, _ = make_sequence(n_frames=n_frames, seed=seed,
                                  sigma_scale=sigma_scale,
                                  noise_sigma=noise_sigma, device=device)
    frames_np = frames.cpu().numpy()
    rows = []
    for family, name, fn in contenders:
        t0 = time.perf_counter()
        try:
            errs = fn(frames, frames_np, gt)
            if frames.is_cuda:
                torch.cuda.synchronize(frames.device)
            rows.append({"family": family, "tracker": name,
                         "avg_mcd_px": round(float(np.mean(errs)), 4),
                         "max_mcd_px": round(float(np.max(errs)), 4),
                         "wall_s": round(time.perf_counter() - t0, 2)})
        except Exception as e:  # a row that raised is reported, and fails
            rows.append({"family": family, "tracker": name,
                         "error": repr(e)[:200]})
    return rows


def verdicts(rows) -> list:
    """Per family: the best of the port's rows against the best OpenCV
    row; parity is the port's at most 0.25 px above OpenCV's."""
    out = []
    for family in dict.fromkeys(r["family"] for r in rows):
        fam = [r for r in rows if r["family"] == family and "avg_mcd_px" in r]
        ours = [r for r in fam if r["tracker"].startswith("mtf_tpu:")]
        cv = [r for r in fam if r["tracker"].startswith("opencv:")]
        if ours and cv:
            best_ours = min(r["avg_mcd_px"] for r in ours)
            best_cv = min(r["avg_mcd_px"] for r in cv)
            out.append({"family": family, "ours_px": best_ours,
                        "opencv_px": best_cv,
                        "parity": best_ours <= best_cv + 0.25})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_frames", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_scale", type=float, default=0.015)
    p.add_argument("--noise_sigma", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)
    rows = head_to_head(args.n_frames, args.seed, args.sigma_scale,
                        args.noise_sigma, device=args.device)
    ver = verdicts(rows)
    for r in rows + ver:
        print(json.dumps(r))
    # a harness failure (no verdict, or a row that raised) is not parity
    if not ver or any("error" in r for r in rows):
        return 2
    return 0 if all(v["parity"] for v in ver) else 1


if __name__ == "__main__":
    raise SystemExit(main())
