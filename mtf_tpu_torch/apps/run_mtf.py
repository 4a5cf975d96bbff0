"""Evaluation harness CLI — the `runMTF` analog (port of
`mtf_tpu/apps/run_mtf.py`).

Re-designs `Examples/cpp/runMTF.cc` (821 LoC; call stack SURVEY.md §3.1):
build tracker from string keys + params, stream frames, track, compute
per-frame error vs GT (MCD/CL/Jaccard), apply the reinit-on-failure
protocol, report FPS and success-rate curves, and write the reference's
artifact formats (corners .txt, .err, .sr, log/tracking_stats.txt).

The tracker runs on the card unless `--device` names another device
(`--device cpu`); without a card and without `--device` it raises. A
single object is a batch of one (B = 1). The warm-up update on frame 0
(which builds the kernels on first use) stays outside the clock, and the
clock is read after the device has finished its work.

Usage:
    python -m mtf_tpu_torch.apps.run_mtf --seq <frame-dir> --gt <gt.txt> \
        sm fclk am ssd ssm 8 max_iters 30
    python -m mtf_tpu_torch.apps.run_mtf --synthetic --n_frames 50 \
        sm esm am ncc
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

# the last run's details, for a caller that drives `main` in-process:
# "tracked" corners (T-1, [N,] 4, 2), "errors", "updates" (the updates
# made, the warm-up included), "state", "summary"
LAST_RUN: dict = {}


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", help="frame directory or video file")
    p.add_argument("--gt", help="ground-truth corners file")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a generated synthetic sequence")
    p.add_argument("--n_frames", type=int, default=50)
    p.add_argument("--config_dir", help="directory of .cfg files")
    p.add_argument("--preproc", default="none")
    p.add_argument("--err_metric", default="mcd",
                   choices=["mcd", "cl", "jaccard"])
    p.add_argument("--reinit_on_failure", action="store_true")
    p.add_argument("--reinit_err_thresh", type=float, default=20.0)
    p.add_argument("--reinit_frame_skip", type=int, default=5)
    p.add_argument("--reinit_at_each_frame", action="store_true",
                   help="fresh template from GT every frame "
                        "(runMTF.cc:560-577 protocol)")
    p.add_argument("--reset_at_each_frame", action="store_true",
                   help="reset region to GT every frame, keep template "
                        "(runMTF.cc:578-599 protocol)")
    p.add_argument("--use_opt_gt", action="store_true",
                   help="score against OptGT/<seq>_<ssm>.txt — GT "
                        "projected onto the tracker's SSM "
                        "(objUtils.cc:948-950); generated on the fly "
                        "from the raw GT when the file is absent")
    p.add_argument("--opt_gt_ssm", default=None,
                   help="SSM key for OptGT (default: the tracker's)")
    p.add_argument("--use_reinit_gt",
                   help="ReinitGT/<seq>.bin path: per-start-frame GT "
                        "used when reinitializing after failure "
                        "(objUtils.cc:1025)")
    p.add_argument("--corners",
                   help="x1,y1,...,x4,y4 init region (GT-less runs, e.g. "
                        "live camera)")
    p.add_argument("--select", action="store_true",
                   help="interactive region selection on frame 0 "
                        "(getObjectsToTrack UI path, pipeline.h:249-276; "
                        "needs a display)")
    p.add_argument("--frame_gap", type=int, default=1,
                   help="track every k-th frame (runMTF.cc:685-690)")
    p.add_argument("--init_frame_id", type=int, default=0,
                   help="start tracking at this frame (objUtils.cc:888)")
    p.add_argument("--invert_seq", action="store_true",
                   help="run the sequence backwards (objUtils.cc:862)")
    p.add_argument("--out_dir", default="log")
    p.add_argument("--device", default=None,
                   help="torch device of the tracker (default: the card; "
                        "cpu for a CPU run)")
    p.add_argument("--write_outputs", action="store_true")
    p.add_argument("--record_tracking",
                   help="write an annotated tracking video (tracked "
                        "region + GT overlay; runMTF.cc:607-674 record "
                        "path)")
    p.add_argument("--multi",
                   help="multi.cfg of per-tracker param blocks: run each "
                        "tracker config over the sequence and report one "
                        "summary line per tracker (the reference's "
                        "tracker-comparison mode, parameters.h:4029)")
    p.add_argument("--n_objs", type=int, default=1,
                   help="track N objects in ONE batched fleet update "
                        "(replaces runMTF.cc:704's per-tracker loop; "
                        "synthetic mode lays out N regions on a grid, "
                        "file mode takes N comma-separated --gt files)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synthetic_input(n_objs: int, n_frames: int, cfg: dict, ssm: str,
                    device):
    """The `--synthetic` sequence: a smoothed noise scene (240x320, from
    `seed`), one region (or `n_objs` on a grid) riding one random-walk
    warp of `syn_ssm` (default the tracker's SSM) with step `syn_sigma`
    (default 0.02). -> (frames (T, H, W) tensor on `device`, GT corners
    (T, 4, 2) or (T, N, 4, 2) numpy)."""
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    try:
        from scipy.ndimage import gaussian_filter as _gf
        img = _gf(rng.standard_normal((240, 320)), 3.0)
    except ImportError:
        img = rng.standard_normal((240, 320))
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    if n_objs > 1:
        # lay N regions on a grid; all ride the same scene warp
        ncol = int(np.ceil(np.sqrt(n_objs)))
        nrow = int(np.ceil(n_objs / ncol))
        cw, ch = 320.0 / ncol, 240.0 / nrow
        boxes = []
        for i in range(n_objs):
            r, c = divmod(i, ncol)
            x0, y0 = c * cw + 0.25 * cw, r * ch + 0.25 * ch
            x1, y1 = x0 + 0.5 * cw, y0 + 0.5 * ch
            boxes.append([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        corners0 = np.asarray(boxes, np.float32)          # (N, 4, 2)
    else:
        corners0 = np.array([[110.0, 70.0], [210.0, 70.0],
                             [210.0, 170.0], [110.0, 170.0]], np.float32)
    gen_ssm = get_ssm(str(cfg.get("syn_ssm", ssm)), device=device)
    return synthetic_sequence(
        img.astype(np.float32), corners0, gen_ssm, n_frames=n_frames,
        sigma_scale=float(cfg.get("syn_sigma", 0.02)),
        seed=int(cfg.get("seed", 0)))


def _strip_multi(argv) -> list:
    """argv without its `--multi <path>` / `--multi=<path>`."""
    cleaned, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--multi":
            skip = True
            continue
        if tok.startswith("--multi="):
            continue
        cleaned.append(tok)
    return cleaned


def main(argv=None):
    args, extra = build_argparser().parse_known_args(argv)

    if args.multi:
        # tracker-comparison mode: one run per multi.cfg block, each
        # block's pairs appended as CLI overrides (last wins, matching
        # the reference's readTrackerParams re-parse per tracker)
        from mtf_tpu_torch.utils.config import read_multi_cfg
        cleaned = _strip_multi(list(argv if argv is not None
                                    else sys.argv[1:]))
        out = []
        for blk in read_multi_cfg(args.multi):
            pairs = []
            for k, v in blk.items():
                vv = (",".join(str(x) for x in v)
                      if isinstance(v, (list, tuple)) else str(v))
                pairs += [str(k), vv]
            out.append(main(cleaned + pairs))
        return out

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.utils import gt as gtio
    from mtf_tpu_torch.utils.config import read_params
    from mtf_tpu_torch.utils.preproc import get_preproc

    dev = _device.resolve(args.device)
    cfg = read_params(args.config_dir, extra)
    sm = str(cfg.pop("sm", "fclk"))
    am = str(cfg.pop("am", "ssd"))
    ssm = str(cfg.pop("ssm", "8"))
    ilm = cfg.pop("ilm", None)
    ilm = None if ilm in (None, "0", 0, "none") else str(ilm)

    preproc = get_preproc(args.preproc)

    # ---- input + GT -------------------------------------------------
    if args.synthetic:
        frames, gt_corners = synthetic_input(args.n_objs, args.n_frames,
                                             cfg, ssm, dev)
        frames = [frames[i] for i in range(frames.shape[0])]
        seq_name = "synthetic"
    else:
        from mtf_tpu_torch.utils.input import get_input
        inp = get_input(args.seq)
        frames = [preproc(torch.as_tensor(np.asarray(f, np.float32),
                                          device=dev)) for f in inp]
        if args.gt and args.n_objs > 1:
            # one GT file per object, comma-separated
            gts = [gtio.read_corners_file(p) for p in args.gt.split(",")]
            tmin = min(len(g) for g in gts)
            gt_corners = np.stack([g[:tmin] for g in gts], axis=1)
        else:
            gt_corners = gtio.read_corners_file(args.gt) if args.gt else None
        seq_name = os.path.basename(os.path.normpath(args.seq))

    # sequence protocol transforms (objUtils.cc:861-894 + runMTF frame_gap)
    if args.invert_seq:
        frames = frames[::-1]
        if gt_corners is not None:
            gt_corners = gt_corners[::-1]
    if args.init_frame_id > 0:
        frames = frames[args.init_frame_id:]
        if gt_corners is not None:
            gt_corners = gt_corners[args.init_frame_id:]
    if args.frame_gap > 1:
        frames = frames[::args.frame_gap]
        if gt_corners is not None:
            gt_corners = gt_corners[::args.frame_gap]

    tracker = create_tracker(sm, am, ssm, ilm, device=dev, **cfg)

    if args.n_objs > 1:
        return _run_fleet(args, tracker, frames, gt_corners, seq_name,
                          f"{sm}/{am}/{ssm}")

    if args.use_opt_gt and gt_corners is not None:
        # low-DOF scoring protocol: read OptGT/<seq>_<ssm>.txt when it
        # exists, else project the raw GT onto the SSM manifold now
        from mtf_tpu_torch.ssm import get_ssm
        opt_key = args.opt_gt_ssm or ssm
        opt_path = (gtio.opt_gt_path(os.path.dirname(args.gt) or ".",
                                     seq_name, opt_key)
                    if args.gt else None)
        if opt_path and os.path.exists(opt_path):
            gt_corners = gtio.read_corners_file(opt_path)
        else:
            gt_corners = gtio.optimize_gt(gt_corners,
                                          get_ssm(opt_key, device=dev))

    init_corners = (np.asarray(gt_corners[0], np.float32)
                    if gt_corners is not None else None)
    if init_corners is None and args.corners:
        init_corners = np.asarray([float(v) for v in args.corners.split(",")],
                                  np.float32).reshape(4, 2)
    if init_corners is None and args.select:
        # interactive rectangle selection (ObjUtils::selectObjects analog)
        import cv2
        from mtf_tpu_torch.utils.viz import to_bgr_u8
        x, y, w_, h_ = cv2.selectROI("select object",
                                     to_bgr_u8(frames[0].cpu().numpy()),
                                     False)
        cv2.destroyAllWindows()
        if w_ > 0 and h_ > 0:
            init_corners = np.asarray(
                [[x, y], [x + w_, y], [x + w_, y + h_], [x, y + h_]],
                np.float32)
    if init_corners is None:
        raise SystemExit("no init region: pass --gt, --corners, or "
                         "--select (display required)")
    return run_single(args, tracker, frames, gt_corners, init_corners,
                      seq_name, (sm, am, ssm))


def run_single(args, tracker, frames, gt_corners, init_corners, seq_name,
               keys):
    """The single-object protocol (runMTF.cc:460-731) on `frames` (a list
    of tensors on the tracker's device) from `init_corners` (4, 2):
    errors against `gt_corners` (T, 4, 2) or None, reinit on failure
    with its skip window, the reinit/reset-at-each-frame modes, the
    summary line and the artifacts. -> (fps, average error)."""
    from mtf_tpu_torch.utils import gt as gtio
    from mtf_tpu_torch.utils import metrics
    sm, am, ssm = keys
    dev = tracker.device

    def region(c):
        return torch.as_tensor(np.asarray(c, np.float32)[None], device=dev)

    def corners_of(st):
        return tracker.corners(st)[0].cpu().numpy().T          # (4, 2)

    state = tracker.initialize(frames[0], region(init_corners))
    # warm-up update on frame 0 (the first call builds the kernels;
    # excluded from FPS, as the JAX package's compile is)
    tracker.update(state, frames[0])
    n_updates = 1
    _sync(dev)

    err_fn = metrics.ERROR_FNS[args.err_metric]
    recorder = None
    if args.record_tracking:
        from mtf_tpu_torch.utils.viz import VideoRecorder, annotate
        recorder = VideoRecorder(args.record_tracking)
    errors, tracked = [], []
    n_failures = 0
    skip_until = -1
    t0 = time.perf_counter()
    for t in range(1, len(frames)):
        if t <= skip_until:
            errors.append(np.nan)
            tracked.append(corners_of(state))
            continue
        state = tracker.update(state, frames[t])
        n_updates += 1
        corners = corners_of(state)
        if gt_corners is not None and t < len(gt_corners):
            err = err_fn(gt_corners[t], corners)
            invalid = not np.all(np.isfinite(corners))
            if args.reinit_on_failure and (
                    invalid or err > args.reinit_err_thresh):
                n_failures += 1
                skip_until = t + args.reinit_frame_skip
                reinit_t = min(skip_until, len(frames) - 1,
                               len(gt_corners) - 1)
                if args.use_reinit_gt:
                    # GT re-optimized from the reinit frame
                    # (objUtils.cc:905-946 getReinitGT)
                    rgt = gtio.read_reinit_gt(args.use_reinit_gt, reinit_t)
                    gt_corners = np.concatenate(
                        [gt_corners[:reinit_t], rgt])[:len(gt_corners)]
                state = tracker.initialize(frames[reinit_t],
                                           region(gt_corners[reinit_t]))
                errors.append(np.nan)
                tracked.append(corners)
                continue
            if invalid:
                from mtf_tpu_torch.utils.excp import InvalidTrackerState
                raise InvalidTrackerState(
                    f"non-finite corners at frame {t} "
                    "(enable --reinit_on_failure to recover)")
            errors.append(err)
            # per-frame evaluation protocols (runMTF.cc:560-599): measure
            # single-frame tracking quality by re-anchoring to GT
            if args.reinit_at_each_frame:
                state = tracker.initialize(frames[t], region(gt_corners[t]))
            elif args.reset_at_each_frame:
                state = tracker.set_region(state, region(gt_corners[t]))
        tracked.append(corners)
        if recorder is not None:
            g = (gt_corners[t] if gt_corners is not None
                 and t < len(gt_corners) else None)
            recorder.write(annotate(frames[t].cpu().numpy(), corners, gt=g))
    _sync(dev)
    dt = time.perf_counter() - t0
    if recorder is not None:
        recorder.close()

    n_tracked = len(frames) - 1
    fps = n_tracked / dt
    errs = np.asarray([e for e in errors if np.isfinite(e)])
    avg_err = float(errs.mean()) if errs.size else float("nan")
    _, sr, mean_sr = metrics.success_rate_curve(errs) if errs.size else \
        (None, None, float("nan"))

    summary = (f"{seq_name} {sm}/{am}/{ssm} frames={n_tracked} "
               f"fps={fps:.1f} avg_{args.err_metric}={avg_err:.3f} "
               f"mean_sr={mean_sr:.3f} failures={n_failures}")
    print(summary)
    LAST_RUN.clear()
    LAST_RUN.update(tracked=np.stack(tracked), errors=np.asarray(errors),
                    updates=n_updates, state=state, summary=summary,
                    fps=fps, avg_err=avg_err, failures=n_failures)

    if args.write_outputs:
        base = os.path.join(args.out_dir, f"{seq_name}_{sm}_{am}_{ssm}")
        gtio.write_corners_file(base + ".txt", np.stack(tracked))
        gtio.write_errors_file(base + ".err", errors)
        try:
            # diagnostics curves (graphUtils.cc analog): per-frame error
            # + SR curve rendered as PNGs next to the artifact files
            from mtf_tpu_torch.utils.viz import render_curves
            render_curves({args.err_metric: errors}, base + "_err.png",
                          title=f"{seq_name} {sm}/{am} per-frame error",
                          x_label="frame", y_label="px")
        except Exception:
            pass
        if errs.size:
            th, sr_curve, _ = metrics.success_rate_curve(errs)
            gtio.write_sr_file(base + ".sr", th, sr_curve)
            try:
                from mtf_tpu_torch.utils.viz import render_curves
                render_curves({"SR": sr_curve}, base + "_sr.png",
                              title=f"{seq_name} {sm}/{am} success rate",
                              x_label="threshold (px)", y_label="SR")
            except Exception:
                pass
        gtio.append_tracking_stats(
            os.path.join(args.out_dir, "tracking_stats.txt"), summary)
    return fps, avg_err


def scatter_obj(batched, i: int, single, n: int):
    """A fleet state of `n` trackers with tracker i's rows replaced by the
    B = 1 state `single` (the same tracker's `initialize`). A leaf with n
    times the single's rows holds rows per tracker (a sub-tracker grid
    holds P a tracker, tracker-major) and gets tracker i's block; a leaf
    of the single's own shape is shared by the fleet (a grid's one
    previous frame, the 0-d update counter) and is left as it is."""
    lb, spec = pytree.tree_flatten(batched)
    ls, spec_s = pytree.tree_flatten(single)
    if spec != spec_s:
        raise ValueError("scatter_obj: the fleet's and the tracker's "
                         "states differ in structure")
    out = []
    for b, s in zip(lb, ls):
        if (isinstance(b, torch.Tensor) and b.dim() > 0
                and b.shape[1:] == s.shape[1:]
                and b.shape[0] == n * s.shape[0]
                and (n > 1 or b.shape == s.shape)):
            k = s.shape[0]
            b = b.clone()
            b[i * k:(i + 1) * k] = s.to(b.dtype)
        out.append(b)
    return pytree.tree_unflatten(out, spec)


def _run_fleet(args, tracker, frames, gt_multi, seq_name, combo):
    """N-object tracking as ONE batched fleet update per frame — the
    replacement for runMTF's per-tracker update loop (runMTF.cc:704) —
    under the full evaluation protocol: per-object reinit-on-failure with
    skip windows (runMTF.cc:499-559) and the reinit/reset-at-each-frame
    modes (runMTF.cc:560-599). A failed object's rows are re-initialized
    from GT by writing a fresh single-tracker state into the fleet's state
    (`scatter_obj`); its healthy neighbours keep tracking uninterrupted —
    per-object errors therefore agree with N separate single-object
    protocol runs. The fleet's shared leaves stay the fleet's: a
    re-initialized RANSAC grid draws from the fleet's update counter,
    where a lone tracker restarts its own."""
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.utils import gt as gtio
    from mtf_tpu_torch.utils import metrics

    if gt_multi is None:
        raise SystemExit("--n_objs > 1 needs GT (or --synthetic)")
    dev = tracker.device

    def region(c):
        return torch.as_tensor(np.asarray(c, np.float32), device=dev)

    err_fn = metrics.ERROR_FNS[args.err_metric]
    N = gt_multi.shape[1]
    fleet = TrackerFleet(tracker)
    states = fleet.initialize(frames[0], region(gt_multi[0]))
    fleet.update(states, frames[0])                 # warm-up, off the clock
    n_updates = 1
    _sync(dev)

    def reinit(states, i, t):
        return scatter_obj(states, i, tracker.initialize(
            frames[t], region(gt_multi[t, i][None])), N)

    T = min(len(frames), len(gt_multi))
    errors = np.full((T - 1, N), np.nan)
    n_failures = np.zeros(N, int)
    skip_until = np.full(N, -1)
    tracked = []
    t0 = time.perf_counter()
    for t in range(1, T):
        states = fleet.update(states, frames[t])
        n_updates += 1
        corners = np.transpose(fleet.corners(states).cpu().numpy(),
                               (0, 2, 1))                    # (N, 4, 2)
        for i in range(N):
            if t <= skip_until[i]:
                # inside a failure skip window; reinit when it ends
                if t == skip_until[i] or t == T - 1:
                    states = reinit(states, i, t)
                continue
            err = err_fn(gt_multi[t, i], corners[i])
            invalid = not np.all(np.isfinite(corners[i]))
            if args.reinit_on_failure and (
                    invalid or err > args.reinit_err_thresh):
                n_failures[i] += 1
                skip_until[i] = t + args.reinit_frame_skip
                if skip_until[i] >= T - 1:  # window past the sequence end
                    skip_until[i] = T - 1
                    states = reinit(states, i, T - 1)
                continue
            errors[t - 1, i] = err
        tracked.append(corners)
        # per-frame evaluation protocols: re-anchor every object to GT
        if args.reinit_at_each_frame:
            states = fleet.initialize(frames[t], region(gt_multi[t]))
        elif args.reset_at_each_frame:
            states = tracker.set_region(states, region(gt_multi[t]))
    _sync(dev)
    dt = time.perf_counter() - t0

    obj_fps = N * (T - 1) / dt     # object-updates per second
    finite = np.isfinite(errors)
    avg_err = float(errors[finite].mean()) if finite.any() else float("nan")
    per_obj = [float(errors[finite[:, i], i].mean())
               if finite[:, i].any() else float("nan") for i in range(N)]
    summary = (f"{seq_name} {combo} objs={N} frames={T - 1} "
               f"fps={(T - 1) / dt:.1f} obj_fps={obj_fps:.1f} "
               f"avg_{args.err_metric}={avg_err:.3f} "
               f"failures={int(n_failures.sum())} "
               f"per_obj=[{', '.join(f'{e:.3f}' for e in per_obj)}]")
    print(summary)
    LAST_RUN.clear()
    LAST_RUN.update(tracked=np.stack(tracked), errors=errors,
                    updates=n_updates, state=states, summary=summary,
                    fps=obj_fps, avg_err=avg_err,
                    failures=int(n_failures.sum()), per_obj=per_obj)
    if args.write_outputs:
        os.makedirs(args.out_dir, exist_ok=True)
        stack = np.stack(tracked)                            # (T-1, N, 4, 2)
        base = os.path.join(
            args.out_dir, f"{seq_name}_{combo.replace('/', '_')}")
        for i in range(N):
            gtio.write_corners_file(f"{base}_obj{i}.txt", stack[:, i])
            gtio.write_errors_file(f"{base}_obj{i}.err", errors[:, i])
        gtio.append_tracking_stats(
            os.path.join(args.out_dir, "tracking_stats.txt"), summary)
    return obj_fps, avg_err


if __name__ == "__main__":
    main()
