"""Ground-truth and tracking-result file I/O in the reference formats
(port of `mtf_tpu/utils/gt.py`).

Formats (reference `objUtils.cc:944` readGT; writer `runMTF.cc:359`,
`miscUtils.h:446-468`):
    GT / corners file: header `frame ulx uly urx ury lrx lry llx lly`,
    then one row per frame: `frame<N>.jpg x1 y1 x2 y2 x3 y3 x4 y4`.
    OptGT: `<path>/OptGT/<seq>_<ssm>.txt` — the GT re-expressed in a
    lower-DOF SSM (objUtils.cc:948-950).
    ReinitGT: `<path>/ReinitGT/<seq>[_<ssm>].bin` — binary triangular
    layout (objUtils.cc:1025-1066): int32 n_frames header, then for each
    reinit start frame r the GT rows for frames r..T-1, 8 float64 each.
"""
from __future__ import annotations

import os
import struct

import numpy as np

HEADER = "frame ulx uly urx ury lrx lry llx lly"


def read_corners_file(path: str) -> np.ndarray:
    """-> (T, 4, 2) float32 corner array (ul, ur, lr, ll)."""
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if i == 0 and not _is_float(parts[1]):
                continue  # header
            vals = [float(v) for v in parts[-8:]]
            rows.append(np.asarray(vals, np.float32).reshape(4, 2))
    return np.stack(rows)


def write_corners_file(path: str, corners: np.ndarray,
                       frame_names: list | None = None) -> None:
    """corners: (T, 4, 2)."""
    corners = np.asarray(corners)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for t, c in enumerate(corners):
            name = (frame_names[t] if frame_names
                    else f"frame{t + 1:05d}.jpg")
            vals = " ".join(f"{v:.4f}" for v in c.reshape(-1))
            f.write(f"{name} {vals}\n")


def write_errors_file(path: str, errors) -> None:
    """Per-frame error file (`.err` outputs, runMTF.cc)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("frame error\n")
        for t, e in enumerate(np.asarray(errors)):
            f.write(f"frame{t + 2:05d}.jpg {e:.6f}\n")


def write_sr_file(path: str, thresholds, sr) -> None:
    """Success-rate curve file (`.sr` outputs, runMTF.cc:771-776)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for t, s in zip(np.asarray(thresholds), np.asarray(sr)):
            f.write(f"{t:.4f}\t{s:.6f}\n")


def append_tracking_stats(path: str, line: str) -> None:
    """log/tracking_stats.txt accumulator (runMTF.cc:794-808)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(line.rstrip() + "\n")


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


# ---- OptGT: GT re-expressed in a lower-DOF SSM -----------------------
def optimize_gt(gt: np.ndarray, ssm) -> np.ndarray:
    """Project (T, 4, 2) GT corners onto an SSM's warp manifold: per
    frame, least-squares-fit the SSM warp taking the first-frame corners
    to the GT corners and emit the fitted corners.

    Functional analog of the reference's pre-computed
    `OptGT/<seq>_<ssm>.txt` files (objUtils.cc:948-950), which hold GT
    "optimized" for a lower-DOF SSM so that low-DOF trackers are scored
    against a target they can actually represent.
    """
    import torch

    gt = np.asarray(gt, np.float32)
    src = torch.as_tensor(gt[0], device=ssm.device)
    dst = torch.as_tensor(gt, device=ssm.device)
    # one batched fit over the frames (the JAX package vmaps it)
    s = ssm.fit_corners(src.expand_as(dst), dst)
    out = ssm.warp_pts(s, src.expand_as(dst))          # (T, 4, 2)
    return out.cpu().numpy().astype(np.float32)


def opt_gt_path(source_path: str, source_name: str, ssm_key: str) -> str:
    return os.path.join(source_path, "OptGT",
                        f"{source_name}_{ssm_key}.txt")


# ---- ReinitGT: per-start-frame GT for the reinit protocol ------------
def write_reinit_gt(path: str, gt_per_start) -> None:
    """gt_per_start: (T, 4, 2) array — slices gt[r:] are written per
    start frame r — or a callable `r -> (T - r, 4, 2)` producing GT
    re-optimized from start frame r (the reference generates these
    offline per SSM). Triangular binary layout of objUtils.cc:1048."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if callable(gt_per_start):
        first = np.asarray(gt_per_start(0), np.float64)
        T = first.shape[0]
        rows = [first] + [np.asarray(gt_per_start(r), np.float64)
                          for r in range(1, T)]
    else:
        arr = np.asarray(gt_per_start, np.float64)
        T = arr.shape[0]
        rows = [arr[r:] for r in range(T)]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", T))
        for block in rows:
            f.write(np.ascontiguousarray(
                block.reshape(-1, 8), np.float64).tobytes())


def read_reinit_gt(path: str, reinit_frame: int) -> np.ndarray:
    """-> (T - reinit_frame, 4, 2): the GT to use after reinitializing at
    `reinit_frame` (objUtils.cc readReinitGT(int) seek semantics)."""
    with open(path, "rb") as f:
        T = struct.unpack("<i", f.read(4))[0]
        if not 0 <= reinit_frame < T:
            raise ValueError(
                f"reinit_frame {reinit_frame} out of range [0, {T})")
        # rows before start r: sum_{i<r} (T - i) = r*T - r*(r-1)/2
        r = reinit_frame
        skip_rows = r * T - (r * (r - 1)) // 2
        f.seek(4 + skip_rows * 8 * 8)
        n = T - r
        data = np.frombuffer(f.read(n * 8 * 8), np.float64, count=n * 8)
    return data.reshape(n, 4, 2).astype(np.float32)


# ---- readers of the run artifacts (.err, .sr, tracking_stats.txt) -----
def read_errors_file(path: str) -> np.ndarray:
    """-> (T - 1,) per-frame errors of a `.err` file (nan where the frame
    was skipped)."""
    with open(path) as f:
        rows = [line.split() for line in f.read().splitlines()[1:] if line]
    return np.asarray([float(r[1]) for r in rows], np.float64)


def read_sr_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (thresholds, success rates) of a `.sr` file."""
    a = np.loadtxt(path, ndmin=2)
    return a[:, 0], a[:, 1]


def read_tracking_stats(path: str) -> list[str]:
    """The summary lines of a tracking_stats.txt, oldest first."""
    with open(path) as f:
        return [line for line in f.read().splitlines() if line]
