"""What decides `correct`: the answers the timed path gave, compared with
the configuration's plain reference (`reference/<config>.py`).

Each answer is a tracker-update's corners. The recorder keeps every
step's corners of a sample of trackers drawn from the seed (and, once
the window has closed, the GT statistics of every tracker-update of the
window). Once the window has
closed, a sample of (tracker, step) pairs drawn from the seed is handed
to the reference: for each, the tracker's init frame and corners, the
corners the program reported for the step before, and the frames of the
step before and of the step; the reference computes the step's corners
on its own, and the widest corner gap of each pair (image px) is taken:

    start_gap_*    over the first update of each sampled tracker, whose
                   state before is the initialisation (the reference's
                   own)
    window_gap_*   over updates of the timed window

each as the widest over the pairs (`..._px`), their 99th percentile
(`..._p99_px`) and their median (`..._median_px`). A cell's `limits`
name the ones it compares; the others are printed beside them. The
cells compare the 99th percentiles over 1,024 sampled trackers: a
tracker's gap is a property of its camera, and a few cameras in a
thousand read gaps near the control's, so the widest gap, or the 99th
percentile of a smaller sample, swings from seed to seed with how many
of them the sample holds (PERF.md, section 4).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import generator

CHUNK = 128              # pairs per reference call


@contextlib.contextmanager
def plain_precision():
    """Full float32 matrix products (TF32 off) while a reference runs."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Recorder:
    """Every step's corners: those of the sampled trackers `rows` for the
    comparison, and the GT statistics of the timed steps, worked out in
    `finish` once the window has closed (so no harness work falls in the
    window but the copy's reference).

    `attempted` and `failed` count every tracker-update of the window;
    `mcd_px` is the mean over the tracker-updates of its first
    `mcd_steps` steps (all of them where the window has fewer): a fixed
    count, because a tracker whose template follows the frames (Median
    Flow) drifts from step to step, and a mean over all the steps of the
    window would read a faster program, which runs more of them, as a
    less accurate one."""

    def __init__(self, streams: generator.Streams, rows: np.ndarray,
                 fail_px: float, mcd_steps: int):
        self.streams = streams
        self.rows = np.asarray(rows)
        self.fail_px = fail_px
        self.mcd_steps = int(mcd_steps)
        self.steps = [(streams.corners0, False)]  # (corners, timed) by step
        self.kept = []
        self.timed = []          # the steps of the timed window
        self.attempted = self.failed = 0
        self.err_sum, self.err_n = 0.0, 0

    def add(self, step: int, corners: np.ndarray, timed: bool) -> None:
        """Corners (B, 4, 2) after update `step` (steps count from 1)."""
        if step != len(self.steps):
            raise ValueError(f"step {step} recorded after "
                             f"{len(self.steps) - 1}")
        self.steps.append((corners, timed))

    def finish(self) -> None:
        """The sampled trackers' corners of every step, and the GT
        statistics of every tracker-update of the timed steps."""
        t = self.streams.gt.shape[0]
        for step, (corners, timed) in enumerate(self.steps):
            self.kept.append(corners[self.rows].astype(np.float64))
            if not timed:
                continue
            self.timed.append(step)
            gt = self.streams.gt[generator.frame_index(step, t)]
            err = np.linalg.norm(corners - gt, axis=-1).mean(-1)
            ok = np.isfinite(err)
            self.attempted += err.size
            self.failed += int((~ok | (err > self.fail_px)).sum())
            if len(self.timed) <= self.mcd_steps:
                self.err_sum += float(err[ok].sum())
                self.err_n += int(ok.sum())
        self.steps = []

    @property
    def mcd_px(self) -> float:
        return self.err_sum / self.err_n if self.err_n else float("nan")


def _frame(streams: generator.Streams, f: int, b: np.ndarray):
    return streams.pool[f][torch.as_tensor(b, device=streams.pool.device)]


def _gap(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per pair, the widest corner distance (px); a corner that is finite
    on one side only counts as infinitely far."""
    d = np.linalg.norm(prog - ref, axis=-1)
    both_bad = ~np.isfinite(prog).all(-1) & ~np.isfinite(ref).all(-1)
    d = np.where(both_bad, 0.0, np.where(np.isfinite(d), d, np.inf))
    return d.max(-1)


def compare(ref, cfg: dict, streams: generator.Streams, rec: Recorder,
            seed: int, per_tracker: int) -> dict:
    """The gaps between the program's and the reference's corners, over
    the first update of every sampled tracker ("start_gap_...") and over
    `per_tracker` window steps of each, drawn from the seed
    ("window_gap_..."): the widest ("..._px"), the 99th percentile
    ("..._p99_px") and the median ("..._median_px") of the pairs'
    widest corner gaps."""
    t = streams.pool.shape[0]
    r = generator.rng(seed, 4)
    pairs = [(j, 1) for j in range(len(rec.rows))]
    if rec.timed:
        pairs += [(j, int(k)) for j in range(len(rec.rows))
                  for k in r.choice(rec.timed, per_tracker)]
    gaps = []
    dev = streams.pool.device
    for a in range(0, len(pairs), CHUNK):
        chunk = pairs[a:a + CHUNK]
        j = np.array([p[0] for p in chunk])
        k = np.array([p[1] for p in chunk])
        b = rec.rows[j]
        prev_c = np.stack([rec.kept[kk - 1][jj] for jj, kk in chunk])
        prog = np.stack([rec.kept[kk][jj] for jj, kk in chunk])
        f_prev = np.array([generator.frame_index(kk - 1, t) for kk in k])
        f_cur = np.array([generator.frame_index(kk, t) for kk in k])
        frame0 = streams.init_frame.expand((len(b),)
                                           + streams.init_frame.shape)
        fr_prev = torch.stack([_frame(streams, f, b[i:i + 1])[0]
                               for i, f in enumerate(f_prev)])
        fr_cur = torch.stack([_frame(streams, f, b[i:i + 1])[0]
                              for i, f in enumerate(f_cur)])
        out = ref.track(cfg, frame0,
                        torch.as_tensor(streams.corners0[b], device=dev),
                        torch.as_tensor(prev_c, dtype=torch.float32,
                                        device=dev), fr_prev, fr_cur)
        gaps.append(_gap(prog, out.double().cpu().numpy()))
    g = np.concatenate(gaps)
    n_start = len(rec.rows)
    out = {}
    for part, v in (("start", g[:n_start]), ("window", g[n_start:])):
        if not len(v):
            v = np.array([np.nan])
        out[f"{part}_gap_px"] = float(v.max())
        for q, label in ((0.99, "p99"), (0.5, "median")):
            out[f"{part}_gap_{label}_px"] = float(
                np.quantile(v, q, method="higher"))
    return out
