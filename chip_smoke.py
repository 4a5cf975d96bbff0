"""Smoke run of the PyTorch/CUDA port (`mtf_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, the tracker-fleet update of the headline
benchmark (FCLK + SSD + 8-DOF homography, 50x50 templates, 10 iterations
as 6 + 3 + 1 coarse-to-fine, dense linear sampling from a 144-px window,
B = 1280 trackers on one 480x640 frame), on the first CUDA device:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the chain kernel K1 from `mtf_tpu_torch/csrc/` and prints the
     build time and ptxas's registers / shared memory / spills;
  3. K1 phase: at B = 1280 and N = 169, 625, 2500 compares the CUDA
     kernel with its plain PyTorch form on the card (val within 1e-3,
     g and JtJ within 1e-4 of their norms) and times both;
  4. fleet phase: 3 warm-up updates, then 3 windows of 20 updates;
     prints the median frames/s and checks that every update launched
     K1 exactly 10 times;
  5. GT phase: a 6-frame synthetic sequence with exact ground truth;
     fails if the mean corner error is above 0.2 px or not finite; the
     first frames are also tracked by the plain path (CPU tensors) for
     8 of the trackers, whose corners must agree within 0.05 px.

Every failed check raises, so the script exits non-zero and prints no
ok line. The last line is {"ok": true, "device": {...}}; the line
before it is the JSON summary of the kernels.
"""
import json
import subprocess
import sys
import time

import numpy as np

B = 1280
RES = 50
CROP = 144
SCHEDULE = ((4, 6), (2, 3))
MAX_ITERS = 10
N_POINTS = (169, 625, 2500)
WARMUP, WINDOWS, STEPS = 3, 3, 20
GT_LIMIT_PX = 0.2
PLAIN_PATH_TRACKERS = 8
PLAIN_PATH_TOL_PX = 0.05


def _scene(seed=0, h=480, w=640):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def _corners(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(120, 520), rng.uniform(100, 380)
        s = rng.uniform(30, 60)
        out.append([[cx - s, cy - s], [cx + s, cy - s],
                    [cx + s, cy + s], [cx - s, cy + s]])
    return np.asarray(out, np.float32)


def _time_ms(torch, fn, reps):
    """Mean device time of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _k1_inputs(torch, frame, n, dev, seed=2):
    """K1 operands at the fleet's shapes: windows cropped from the scene
    at random places, random near-identity homographies of the
    stride-decimated 50x50 template grid, random templates."""
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    h, w = frame.shape
    ys = torch.as_tensor(rng.integers(0, h - CROP, B), device=dev)
    xs = torch.as_tensor(rng.integers(0, w - CROP, B), device=dev)
    ar = torch.arange(CROP, device=dev)
    win = frame[(ys[:, None] + ar)[:, :, None],
                (xs[:, None] + ar)[:, None, :]].contiguous()
    side = int(round(n ** 0.5))
    g = W.unit_square_grid(side, side, device=dev)
    ph = torch.cat([g.T, torch.ones(1, n, device=dev)])
    ph = ph.expand(B, 3, n).contiguous()
    ssm = get_ssm("8", device=dev)
    state = torch.as_tensor(rng.normal(0, 0.02, (B, 8)), dtype=torch.float32,
                            device=dev)
    norm = torch.tensor([[80.0, 0, 72], [0, 80.0, 72], [0, 0, 1]],
                        device=dev)
    M0 = (norm @ ssm.to_matrix(state)).contiguous()
    templ = torch.as_tensor(rng.uniform(0, 255, (B, n)), dtype=torch.float32,
                            device=dev)
    return win, M0, ssm.generators, ph, templ


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import lk_fused as k1
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.utils.synth import synthetic_sequence

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load("lk_fused_chain")
    print(f"build: lk_fused_chain nvcc {built.seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # -- K1 phase -----------------------------------------------------------
    frame0 = _scene(0)
    frame_d = torch.as_tensor(frame0, device=dev)
    k1_rows = {}
    for n in N_POINTS:
        args = _k1_inputs(torch, frame_d, n, dev)
        val, g, h = k1.lk_fused_chain(*args)
        torch.cuda.synchronize()
        v0, g0, h0 = k1.lk_fused_chain_ref(*args)
        err_v = float((val - v0).abs().max())
        err_g = float(((g - g0).abs().amax(-1)
                       / torch.linalg.vector_norm(g0, dim=-1)).max())
        err_h = float(((h - h0).abs().amax((-2, -1))
                       / torch.linalg.matrix_norm(h0)).max())
        _check(all(np.isfinite([err_v, err_g, err_h])),
               f"K1 N={n}: non-finite output")
        _check(err_v <= 1e-3 and err_g <= 1e-4 and err_h <= 1e-4,
               f"K1 N={n}: cuda vs plain val {err_v} g {err_g} JtJ {err_h}")
        ms = _time_ms(torch, lambda: k1.lk_fused_chain(*args), 50)
        plain_ms = _time_ms(torch, lambda: k1.lk_fused_chain_ref(*args), 5)
        k1_rows[n] = dict(err_v=err_v, err_g=err_g, err_h=err_h, ms=ms,
                          plain_ms=plain_ms)
        print(f"K1 N={n} B={B}: max|dval| {err_v:.3g}, g {err_g:.3g}, "
              f"JtJ {err_h:.3g} of norm; cuda {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})")
        del args, val, g, h, v0, g0, h0
    torch.cuda.empty_cache()

    # -- fleet phase (main path) -------------------------------------------
    sm = create_tracker("fclk", "ssd", "8", resx=RES, resy=RES,
                        max_iters=MAX_ITERS, epsilon=0.0,
                        interp="linear_mm", crop=CROP,
                        coarse_pt_iters=SCHEDULE, device=dev)
    fleet = TrackerFleet(sm, donate=True)
    corners = _corners(B)
    k1.lk_fused_chain.launches = 0
    states = fleet.initialize(frame_d, corners)
    torch.cuda.synchronize()
    for _ in range(WARMUP):
        states = fleet.update(states, frame_d)
    torch.cuda.synchronize()
    rates = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            states = fleet.update(states, frame_d)
        torch.cuda.synchronize()
        rates.append(B * STEPS / (time.perf_counter() - t0))
    launches = k1.lk_fused_chain.launches
    n_updates = WARMUP + WINDOWS * STEPS
    _check(launches > 0, "fleet phase never launched K1")
    _check(launches == MAX_ITERS * n_updates,
           f"K1 launched {launches} times in {n_updates} updates")
    _check(bool(torch.isfinite(states.ssm_state).all()),
           "fleet state not finite")
    fps = sorted(rates)[len(rates) // 2]
    print(f"fleet B={B}: {fps:.1f} frames/s median of "
          f"{[round(r, 1) for r in rates]} ({card}); K1 launches "
          f"{launches} = {MAX_ITERS} x {n_updates} updates")

    # -- GT phase ---------------------------------------------------------
    frames, gt = synthetic_sequence(frame0, corners, sm.ssm, n_frames=6,
                                    sigma_scale=0.004, seed=3)
    fleet = TrackerFleet(sm)
    states = fleet.initialize(frames[0], corners)
    errs = []
    for t in range(1, len(frames)):
        states = fleet.update(states, frames[t])
        c = fleet.corners(states).cpu().numpy()          # (B, 2, 4)
        errs.append(float(np.mean(np.linalg.norm(
            np.transpose(c, (0, 2, 1)) - gt[t], axis=-1))))
    gt_px = float(np.mean(errs))
    _check(np.isfinite(gt_px) and gt_px <= GT_LIMIT_PX,
           f"GT mean corner error {gt_px} px (limit {GT_LIMIT_PX})")
    print(f"GT: mean corner error {gt_px:.4f} px over {len(errs)} frames "
          f"(per frame {[round(e, 4) for e in errs]})")

    # the same trackers on the plain path (CPU tensors: plain K1) agree
    cpu_sm = create_tracker("fclk", "ssd", "8", resx=RES, resy=RES,
                            max_iters=MAX_ITERS, epsilon=0.0,
                            interp="linear_mm", crop=CROP,
                            coarse_pt_iters=SCHEDULE, device="cpu")
    sub = corners[:PLAIN_PATH_TRACKERS]
    st_g = sm.initialize(frames[0], sub)
    st_c = cpu_sm.initialize(frames[0].cpu(), sub)
    diff = 0.0
    for t in range(1, 3):
        st_g = sm.update(st_g, frames[t])
        st_c = cpu_sm.update(st_c, frames[t].cpu())
        diff = max(diff, float((sm.corners(st_g).cpu()
                                - cpu_sm.corners(st_c)).abs().max()))
    _check(diff < PLAIN_PATH_TOL_PX,
           f"CUDA path vs plain path corners differ by {diff} px")
    print(f"plain-path check: {PLAIN_PATH_TRACKERS} trackers, 2 frames, "
          f"max corner diff {diff:.3g} px")

    row = k1_rows[2500]
    print(json.dumps({"kernels": [{
        "name": "lk_fused_chain",
        "route": "cuda",
        "source": "mtf_tpu_torch/csrc/lk_fused_chain.cu",
        "replaces": "mtf_tpu/ops/pallas/lk_fused.py:442",
        "launches": launches,
        "max_abs_err": max(r["err_v"] for r in k1_rows.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "shape": f"B={B}, window {CROP}x{CROP}, N=2500",
        "by_n": {str(n): {"ms": r["ms"], "plain_ms": r["plain_ms"]}
                 for n, r in k1_rows.items()},
    }], "fleet_fps": fps, "gt_px": gt_px, "build_s": built.seconds,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
