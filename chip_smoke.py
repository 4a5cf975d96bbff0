"""Smoke run of the PyTorch/CUDA port (`mtf_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the first CUDA device: the tracker-fleet
update of the headline benchmark (slice 1: FCLK + SSD + 8-DOF homography,
B = 1280) and of the esm_ncc benchmark row (slice 2: ESM + NCC, B = 1024,
and its Levenberg-Marquardt variant eslm), all with 50x50 templates,
10 iterations as 6 + 3 + 1 coarse-to-fine and dense linear sampling from a
144-px window on one 480x640 frame:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the chain kernel library from `mtf_tpu_torch/csrc/` (its four
     instantiations: K1 ssd, K2 ncc, K3 ssd_esm and ncc_esm) and prints
     the build time and each instantiation's registers and spills;
  3. kernel phase: at the fleets' shapes (K1 B = 1280, the others
     B = 1024; N = 169, 625, 2500) compares each CUDA kernel with its
     plain PyTorch form on the card (val within 1e-3, every raw sum within
     1e-4 of its norm; NCC's combined g and H within 1e-3 of their norms,
     see NCC_COMBINED_REL) and times both by CUDA events; computes each
     launch's bound from its inputs (the bytes it must move over 3.35 TB/s,
     its FLOPs over 67 TFLOP/s float32);
  4. fclk/ssd fleet: 3 warm-up updates, then 3 windows of 20 updates;
     prints the median frames/s and checks that every update launched K1
     exactly 10 times; a 6-frame synthetic GT leg (mean corner error
     <= 0.2 px); 8 trackers over 2 frames on the plain path (CPU tensors)
     against the CUDA path (<= 0.05 px);
  5. esm/ncc fleet: the same three checks at B = 1024, each update
     launching the ncc_esm kernel exactly 10 times;
  6. eslm/ncc fleet (LM on): the GT leg, the 10-launch check and one
     timed window of 20 updates. Its GT limit: the JAX package on the
     CPU over the same leg, first 8 trackers, reads 0.0902 px (per frame
     0.1114, 0.0854, 0.0976, 0.0707, 0.0857;
     `scripts/port_eslm_reference_leg.py`); at or under 0.1 px the limit
     is 0.2 px;
  7. fclk/ncc and esm/ssd fleets, B = 1024, 3 updates each: the two
     remaining kernel modes launched through the tracker entry points,
     10 times per update.

Launch counts are set to 0 just before each fleet path and read just
after it. Every failed check raises, so the script exits non-zero and
prints no ok line. The last line is {"ok": true, "device": {...}}; the
line before it is the JSON summary of the kernels.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

B = 1280                 # slice 1 fleet (bench.py headline)
B_SLICE2 = 1024          # slice 2 fleet (bench_extra.py esm_ncc row)
RES = 50
CROP = 144
SCHEDULE = ((4, 6), (2, 3))
MAX_ITERS = 10
N_POINTS = (169, 625, 2500)
WARMUP, WINDOWS, STEPS = 3, 3, 20
GT_LIMIT_PX = 0.2
ESLM_GT_LIMIT_PX = 0.2
PLAIN_PATH_TRACKERS = 8
PLAIN_PATH_TOL_PX = 0.05
# NCC's combined g and H subtract nv m mᵀ and u uᵀ from R and divide by
# the variance; summation-order differences of the raw sums (within 1e-4
# of their norms) come out of that cancellation amplified
NCC_COMBINED_REL = 1e-3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12
# (am, esm) -> kernel name, TPU kernel it replaces
MODES = {("ssd", False): "K1", ("ncc", False): "K2", ("ssd", True): "K3",
         ("ncc", True): "K2+K3"}
REPLACES = "mtf_tpu/ops/pallas/lk_fused.py:442"
SOURCE = "mtf_tpu_torch/csrc/lk_fused_chain.cu"


def slice_cfg():
    """The fleets' tracker configuration (bench.py, bench_extra.py)."""
    return dict(resx=RES, resy=RES, max_iters=MAX_ITERS, epsilon=0.0,
                interp="linear_mm", crop=CROP, coarse_pt_iters=SCHEDULE)


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


def _ptxas_usage(log):
    """{(am, esm): (registers, spill store bytes, spill load bytes)} of
    each kernel instantiation, from `nvcc -Xptxas -v` output (the
    template's bool arguments mangle as Lb0E / Lb1E)."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "lk_fused_chain_kernel" in name:
            flags = re.findall(r"Lb([01])E", name)
            key = ("ncc" if flags[0] == "1" else "ssd", flags[1] == "1")
            usage[key] = (int(m.group(1)),) + spills
    return usage


def _chain_inputs(torch, frame, n, b, am, esm, dev, seed=2):
    """Chain-kernel operands at the fleets' shapes: windows cropped from
    the scene at random places, random near-identity homographies of the
    stride-decimated 50x50 template grid, random templates (for NCC
    centred and of unit norm), and for ESM a J0 on the pixel Jacobian's
    scale."""
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    h, w = frame.shape
    ys = torch.as_tensor(rng.integers(0, h - CROP, b), device=dev)
    xs = torch.as_tensor(rng.integers(0, w - CROP, b), device=dev)
    ar = torch.arange(CROP, device=dev)
    win = frame[(ys[:, None] + ar)[:, :, None],
                (xs[:, None] + ar)[:, None, :]].contiguous()
    side = int(round(n ** 0.5))
    g = W.unit_square_grid(side, side, device=dev)
    ph = torch.cat([g.T, torch.ones(1, n, device=dev)])
    ph = ph.expand(b, 3, n).contiguous()
    ssm = get_ssm("8", device=dev)
    state = torch.as_tensor(rng.normal(0, 0.02, (b, 8)), dtype=torch.float32,
                            device=dev)
    norm = torch.tensor([[80.0, 0, 72], [0, 80.0, 72], [0, 0, 1]],
                        device=dev)
    M0 = (norm @ ssm.to_matrix(state)).contiguous()
    templ = torch.as_tensor(rng.uniform(0, 255, (b, n)), dtype=torch.float32,
                            device=dev)
    if am == "ncc":
        c = templ - templ.mean(-1, keepdim=True)
        templ = (c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True)
                      + 1e-8)).contiguous()
    j0 = None
    if esm:
        j0 = torch.as_tensor(rng.normal(0, 30.0, (b, 8, n)),
                             dtype=torch.float32, device=dev)
    return (win, M0, ssm.generators, ph, templ), j0


def _bound_ms(torch, args, am, esm):
    """Least time of one launch on the card: the bytes it must move (each
    input read once: the window pixels its points' 4 taps cover, the
    warps, points, template and J0; each output written once) over the
    HBM rate, against its FLOPs over the float32 rate. Returns (ms,
    "bytes" | "operations", bytes, flops)."""
    win, M0, gens, ph, templ = args
    b, hc, wc = win.shape
    n = ph.shape[-1]
    q = M0 @ ph
    x = torch.clamp(q[:, 0] / q[:, 2], 0.001, wc - 1.001).floor().long()
    y = torch.clamp(q[:, 1] / q[:, 2], 0.001, hc - 1.001).floor().long()
    i00 = y * wc + x
    taps = torch.cat([i00, i00 + 1, i00 + wc, i00 + wc + 1], dim=-1)
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    cover.scatter_(1, taps, True)
    s = 8
    n_out = s + s * s + ((2 * s + 5) if am == "ncc" else 0)
    nbytes = 4 * (int(cover.sum()) + b * (9 + 3 * n + n) + gens.numel()
                  + (b * s * n if esm else 0) + b * n + b * n_out)
    # per point: projection and reciprocal ~20, bilinear value and
    # derivatives ~20, warp Jacobian 24 per state dim, ESM mean 2 per
    # dim, 2 per accumulator
    n_acc = s + s * (s + 1) // 2 + ((2 * s + 5) if am == "ncc" else 0)
    per_pt = 40 + 24 * s + (2 * s if esm else 0) + 2 * n_acc
    flops = b * n * per_pt
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _rel_err(torch, got, want):
    """Max over trackers of max |got - want| / ‖want‖ (per tracker)."""
    dims = tuple(range(1, got.dim()))
    return float(((got - want).abs().amax(dims)
                  / torch.linalg.vector_norm(want, dim=dims)).max())


def _kernel_phase(torch, tk, frame_d, card, dev):
    """Every instantiation against its plain form and timed, at each N."""
    rows = {}
    for (am, esm), label in MODES.items():
        b = B if label == "K1" else B_SLICE2
        mode = tk.mode_name(am, esm)
        for n in N_POINTS:
            args, j0 = _chain_inputs(torch, frame_d, n, b, am, esm, dev)
            got = tk.lk_fused_chain_raw(*args, am=am, j0=j0)
            torch.cuda.synchronize()
            want = tk.lk_fused_chain_ref(*args, am=am, j0=j0)
            err_v = float((got[0] - want[0]).abs().max())
            err_raw = max(_rel_err(torch, a, w)
                          for a, w in zip(got[1:], want[1:]))
            _check(np.isfinite(err_v) and np.isfinite(err_raw),
                   f"{label} N={n}: non-finite output")
            _check(err_v <= 1e-3 and err_raw <= 1e-4,
                   f"{label} N={n}: cuda vs plain val {err_v}, raw sums "
                   f"{err_raw} of norm")
            row = dict(b=b, err_v=err_v, err_raw=err_raw)
            if am == "ncc":
                gk, hk = tk.ncc_combine(*got[1:])
                gp, hp = tk.ncc_combine(*want[1:])
                row["err_g"] = _rel_err(torch, gk, gp)
                row["err_h"] = _rel_err(torch, hk, hp)
                _check(row["err_g"] <= NCC_COMBINED_REL
                       and row["err_h"] <= NCC_COMBINED_REL,
                       f"{label} N={n}: combined g {row['err_g']} H "
                       f"{row['err_h']} of norm")
            del got, want
            row["ms"] = _time_ms(torch, lambda: tk.lk_fused_chain_raw(
                *args, am=am, j0=j0), 50)
            row["plain_ms"] = _time_ms(torch, lambda: tk.lk_fused_chain_ref(
                *args, am=am, j0=j0), 5)
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _bound_ms(torch, args, am, esm)
            rows[(mode, n)] = row
            extra = ("" if am != "ncc" else
                     f", combined g {row['err_g']:.3g} H {row['err_h']:.3g}")
            print(f"{label} {mode} N={n} B={b}: max|dval| {err_v:.3g}, raw "
                  f"sums {err_raw:.3g} of norm{extra}; cuda "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} "
                  f"GFLOP) ({card})")
            del args, j0
            torch.cuda.empty_cache()
    return rows


def _fleet(torch, key, am, b, card, corners, frame_d, dev, tk, mode,
           windows=WINDOWS, warmup=WARMUP):
    """The fleet's main path: `warmup` updates, then `windows` timed
    windows of STEPS updates; the launch counts are zeroed just before
    and read just after, and `mode` must launch 10 times per update."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    sm = create_tracker(key, am, "8", device=dev, **slice_cfg())
    fleet = TrackerFleet(sm, donate=True)
    for k in tk.lk_fused_chain_raw.launches:
        tk.lk_fused_chain_raw.launches[k] = 0
    states = fleet.initialize(frame_d, corners)
    for _ in range(warmup):
        states = fleet.update(states, frame_d)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            states = fleet.update(states, frame_d)
        torch.cuda.synchronize()
        rates.append(b * STEPS / (time.perf_counter() - t0))
    launches = dict(tk.lk_fused_chain_raw.launches)
    n_updates = warmup + windows * STEPS
    _check(launches[mode] == MAX_ITERS * n_updates,
           f"{key}/{am}: {mode} launched {launches[mode]} times in "
           f"{n_updates} updates")
    _check(sum(launches.values()) == launches[mode],
           f"{key}/{am}: other kernel modes launched: {launches}")
    _check(bool(torch.isfinite(states.ssm_state).all()),
           f"{key}/{am}: fleet state not finite")
    fps = sorted(rates)[len(rates) // 2] if rates else None
    print(f"fleet {key}/{am} B={b}: "
          + (f"{fps:.1f} frames/s median of {[round(r, 1) for r in rates]}"
             if rates else "untimed")
          + f" ({card}); {mode} launches {launches[mode]} = {MAX_ITERS} x "
          f"{n_updates} updates")
    return sm, fps, launches[mode]


def _gt_leg(sm, frame0, corners, limit, label):
    """6-frame synthetic sequence with exact GT; mean corner error."""
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.utils.synth import synthetic_sequence
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
    _check(np.isfinite(gt_px) and gt_px <= limit,
           f"{label} GT mean corner error {gt_px} px (limit {limit})")
    print(f"{label} GT: mean corner error {gt_px:.4f} px over {len(errs)} "
          f"frames (per frame {[round(e, 4) for e in errs]}), limit {limit}")
    return gt_px, frames


def _plain_path_check(sm, key, am, frames, corners, label):
    """The same trackers on the plain path (CPU tensors: the kernels'
    plain forms) agree with the CUDA path."""
    from mtf_tpu_torch import create_tracker
    cpu_sm = create_tracker(key, am, "8", device="cpu", **slice_cfg())
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
           f"{label}: CUDA path vs plain path corners differ by {diff} px")
    print(f"{label} plain-path check: {PLAIN_PATH_TRACKERS} trackers, 2 "
          f"frames, max corner diff {diff:.3g} px")
    return diff


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import lk_fused as tk

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load("lk_fused_chain")
    print(f"build: lk_fused_chain nvcc {built.seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    usage = _ptxas_usage(built.log)
    for key, label in MODES.items():
        _check(key in usage, f"ptxas reported no {label} instantiation")
        regs, st, ld = usage[key]
        print(f"ptxas: {label} {tk.mode_name(*key)}: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B")

    # -- kernel phase ---------------------------------------------------------
    frame0 = _scene(0)
    frame_d = torch.as_tensor(frame0, device=dev)
    rows = _kernel_phase(torch, tk, frame_d, card, dev)

    # -- slice 1: fclk/ssd fleet, GT leg, plain path -------------------------
    corners = _corners(B)
    sm, fps1, launches_ssd = _fleet(torch, "fclk", "ssd", B, card, corners,
                                    frame_d, dev, tk, "ssd")
    gt1, frames = _gt_leg(sm, frame0, corners, GT_LIMIT_PX, "fclk/ssd")
    _plain_path_check(sm, "fclk", "ssd", frames, corners, "fclk/ssd")
    del sm, frames
    torch.cuda.empty_cache()

    # -- slice 2: esm/ncc fleet, GT leg, plain path --------------------------
    corners2 = _corners(B_SLICE2)
    sm, fps2, launches_ncc_esm = _fleet(torch, "esm", "ncc", B_SLICE2, card,
                                        corners2, frame_d, dev, tk,
                                        "ncc_esm")
    gt2, frames = _gt_leg(sm, frame0, corners2, GT_LIMIT_PX, "esm/ncc")
    plain2 = _plain_path_check(sm, "esm", "ncc", frames, corners2, "esm/ncc")
    del sm, frames

    # -- eslm/ncc: LM on ----------------------------------------------------
    sm, fps_lm, launches_lm = _fleet(torch, "eslm", "ncc", B_SLICE2, card,
                                     corners2, frame_d, dev, tk, "ncc_esm",
                                     windows=1)
    gt_lm, _ = _gt_leg(sm, frame0, corners2, ESLM_GT_LIMIT_PX, "eslm/ncc")
    del sm
    torch.cuda.empty_cache()

    # -- the remaining modes through the entry points --------------------------
    mode_launches = {"ssd": launches_ssd, "ncc_esm": launches_ncc_esm}
    for key, am, mode in (("fclk", "ncc", "ncc"), ("esm", "ssd", "ssd_esm")):
        _, _, mode_launches[mode] = _fleet(torch, key, am, B_SLICE2, card,
                                           corners2, frame_d, dev, tk, mode,
                                           windows=0)

    kernels = []
    for (am, esm), label in MODES.items():
        mode = tk.mode_name(am, esm)
        row = rows[(mode, N_POINTS[-1])]
        regs, st, ld = usage[(am, esm)]
        kernels.append({
            "name": f"lk_fused_chain[{mode}] ({label})",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": mode_launches[mode],
            "max_abs_err": max(rows[(mode, n)]["err_v"] for n in N_POINTS),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"B={row['b']}, window {CROP}x{CROP}, N=2500",
            "registers": regs,
            "spill_stores": st,
            "spill_loads": ld,
            "max_raw_rel_err": max(rows[(mode, n)]["err_raw"]
                                   for n in N_POINTS),
            "by_n": {str(n): {k: rows[(mode, n)][k] for k in
                              ("ms", "plain_ms", "bound_ms", "err_v",
                               "err_raw") + (("err_g", "err_h")
                                             if am == "ncc" else ())}
                     for n in N_POINTS},
        })
    print(json.dumps({
        "kernels": kernels,
        "fleets": {"fclk_ssd": {"B": B, "fps": fps1, "gt_px": gt1},
                   "esm_ncc": {"B": B_SLICE2, "fps": fps2, "gt_px": gt2,
                               "plain_path_px": plain2},
                   "eslm_ncc": {"B": B_SLICE2, "fps": fps_lm,
                                "gt_px": gt_lm,
                                "launches": launches_lm}},
        "build_s": built.seconds,
        "wall_s": time.perf_counter() - t_start,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
