"""Smoke run of the PyTorch/CUDA port (`mtf_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the first CUDA device: the tracker-fleet
update of the headline benchmark (slice 1: FCLK + SSD + 8-DOF homography,
B = 1280), of the esm_ncc benchmark row (slice 2: ESM + NCC, B = 1024,
and its Levenberg-Marquardt variant eslm), all with 50x50 templates,
10 iterations as 6 + 3 + 1 coarse-to-fine and dense linear sampling from a
144-px window on one 480x640 frame, of the rklt row (slice 3: the
grid tracker with RANSAC, refined by ESM-LM + SSD from a 160-px window,
B = 384), and of slice 4: the mcssd row (FCLK + 3-channel SSD, B = 512,
on a 480x640x3 frame, `bench_extra.py:399-472`) and the headline fleet
with cubic taps (`interp="cubic_mm"` / `"cubic_bspl_mm"`):

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernel libraries from `mtf_tpu_torch/csrc/`, one nvcc per
     source, side by side: the chain kernel (15 instantiations: K1 ssd,
     K2 ncc, K3 ssd_esm and ncc_esm, K4 ssd_mc, each with linear taps
     and, as K1c, with cubic and cubic_bspl taps) and the grid-flow
     kernel K5; prints the build times and each instantiation's registers
     and spills;
  3. kernel phase: at the fleets' shapes (ssd B = 1280, the other single-
     channel modes B = 1024, ssd_mc B = 512 with C = 3 and also C = 2 and
     4; N = 169, 625, 2500; every mode with each tap kind) compares each
     CUDA kernel with its plain PyTorch form on the card (val within 1e-3,
     every raw sum within 1e-4 of its norm; NCC's combined g and H within
     1e-3 of their norms, see NCC_COMBINED_REL) and times both by CUDA
     events; computes each launch's bound from its inputs (the bytes it
     must move over 3.35 TB/s, its FLOPs over 67 TFLOP/s float32);
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
     10 times per update;
  8. K5 phase: the grid-flow operands of real rklt trackers (B = 384,
     P = 100 patches) on the scene at both pyramid levels (level 1: 16
     points per patch, 8 iterations, 96-px windows; level 0: 64 points,
     1 iteration, 160-px windows); the CUDA kernel against its plain
     form on the card (disp within 1e-4 template units on all but 0.1%
     of patches, every one within 1e-2: see K5_TOL), both timed by CUDA
     events, and each level's bound (the window pixels the taps
     cover, 12 B per point, the disp written, over 3.35 TB/s, against
     ~60 FLOPs per point per iteration over 67 TFLOP/s);
  9. rklt/ssd fleet, B = 384: 3 warm-ups and 3 windows of 20 updates,
     each update launching K5 exactly 2 times and the ssd_esm chain
     kernel exactly 10 times; the GT leg (limit 0.2 px: the JAX package
     on the CPU over the same leg, first 8 trackers, reads 0.0930 px,
     `scripts/port_rklt_reference_leg.py`); 8 trackers over 2 frames on
     the plain path against the CUDA path (<= 0.05 px), both given the
     CUDA path's RANSAC draws;
 10. mcssd fleet, B = 512, on the 3-channel scene: 3 warm-ups and 3
     windows of 20 updates, each update launching ssd_mc exactly 10
     times; the gray twin (fclk/ssd on channel 0, B = 512) the same way
     in the same run, and their frames/s ratio; the GT leg (3-channel
     sequence) and the plain-path check; fclm/mcssd (LM on) for 3
     updates and its GT leg;
 11. the headline fleet with cubic taps, B = 1280: cubic_mm timed as in
     4 (ssd@cubic 10 times per update), cubic_bspl_mm for 3 updates,
     each with its GT leg and plain-path check; then every other mode
     with each cubic kind through the entry points (fclk/ncc, esm/ssd,
     esm/ncc at B = 1024, fclk/mcssd at B = 512), 3 updates each.
 GT limits of the slice-4 legs, from the JAX package on the CPU over the
 same legs, first 8 trackers: fclk/mcssd and fclm/mcssd both read
 0.0863 px (per frame 0.103, 0.0879, 0.0955, 0.073, 0.072;
 `scripts/port_mc_reference_leg.py`), fclk/ssd cubic_mm 0.0936 px
 (0.1201, 0.0959, 0.0926, 0.068, 0.0912) and cubic_bspl_mm 0.0395 px
 (0.0477, 0.0387, 0.0421, 0.0308, 0.0384;
 `scripts/port_cubic_reference_leg.py`); all at or under 0.1 px, so
 every limit is 0.2 px.

Launch counts (the chain kernel's per mode, K5's) are set to 0 just
before each fleet path and read just after it. Every failed check raises, so the script exits non-zero and
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
# (am, esm, multi-channel) -> kernel name; every mode is also built with
# each cubic tap kind (K1c)
MODES = {("ssd", False, False): "K1", ("ncc", False, False): "K2",
         ("ssd", True, False): "K3", ("ncc", True, False): "K2+K3",
         ("ssd", False, True): "K4"}
KINDS = ("linear", "cubic", "cubic_bspl")
REPLACES = "mtf_tpu/ops/pallas/lk_fused.py:442"
SOURCE = "mtf_tpu_torch/csrc/lk_fused_chain.cu"
B_RKLT = 384             # slice 3 fleet (bench_extra.py rklt row)
CROP_RKLT = 160
RKLT_GT_LIMIT_PX = 0.2
K5_PER_UPDATE = 2        # one grid-flow launch per pyramid level
# K5 disp, template units: every patch within K5_MAX and all but
# K5_OVER_SHARE of them within K5_TOL. A patch whose point lands within
# float32 rounding of a pixel boundary (where the dense derivative steps)
# can go either way in any two float32 forms: on the card 1 of 38,400
# level-1 patches differed by 8.2e-4, and the float64 plain form differed
# from both float32 forms by the same amount there
K5_TOL = 1e-4
K5_OVER_SHARE = 1e-3
K5_MAX = 1e-2
K5_FLOPS_PER_PT_ITER = 60
K5_REPLACES = "mtf_tpu/ops/pallas/grid_flow.py:243"
K5_SOURCE = "mtf_tpu_torch/csrc/grid_flow.cu"
B_MC = 512               # slice 4 MC fleet (bench_extra.py mcssd row)
MC_CHANNELS = (3, 2, 4)  # the fleet's 3 first
# GT limits of the slice-4 legs: the JAX package on the CPU over the same
# legs, first 8 trackers, reads 0.0863 (mcssd, fclk and fclm), 0.0936
# (cubic_mm) and 0.0395 px (cubic_bspl_mm), all at or under 0.1 px
# (scripts/port_mc_reference_leg.py, scripts/port_cubic_reference_leg.py)
MC_GT_LIMIT_PX = 0.2
FCLM_MC_GT_LIMIT_PX = 0.2
CUBIC_GT_LIMIT_PX = 0.2
CUBIC_BSPL_GT_LIMIT_PX = 0.2


def slice_cfg(interp="linear_mm"):
    """The fleets' tracker configuration (bench.py, bench_extra.py), with
    `interp`'s taps."""
    return dict(resx=RES, resy=RES, max_iters=MAX_ITERS, epsilon=0.0,
                interp=interp, crop=CROP, coarse_pt_iters=SCHEDULE)


def rklt_cfg():
    """The rklt row's configuration (bench_extra.py:363-379)."""
    return dict(slice_cfg(), crop=CROP_RKLT, grid_sub_iters=(1, 8),
                grid_coarse_stride=2)


def cfg_of(key, interp="linear_mm"):
    return rklt_cfg() if key == "rklt" else slice_cfg(interp)


def _scene(seed=0, h=480, w=640):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def _scene3(seed=0, h=480, w=640):
    """3-channel smooth scene: shared structure plus per-channel detail
    (correlated channels, like natural imagery); the mcssd row's scene
    (`bench_extra.py:_scene3`)."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    chans = []
    for _ in range(3):
        d = np.cumsum(np.cumsum(rng.normal(0, 0.4, (h, w)), 0), 1)
        chans.append(base + d)
    img = np.stack(chans, -1)
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
    """{(am, esm, mc, kind): (registers, spill store bytes, spill load
    bytes)} of each kernel instantiation, from `nvcc -Xptxas -v` output
    (the template's bool arguments mangle as Lb0E / Lb1E, the tap kind as
    Li<k>E)."""
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
            kind = KINDS[int(re.search(r"Li(\d)E", name).group(1))]
            key = ("ncc" if flags[0] == "1" else "ssd", flags[1] == "1",
                   flags[2] == "1", kind)
            usage[key] = (int(m.group(1)),) + spills
    return usage


def _chain_inputs(torch, frame, n, b, am, esm, dev, seed=2):
    """Chain-kernel operands at the fleets' shapes: windows cropped from
    the scene at random places ((B, C, 144, 144) channel-stacked for an
    (H, W, C) frame), random near-identity homographies of the
    stride-decimated 50x50 template grid, random templates ((B, C, N)
    for C channels; for NCC centred and of unit norm), and for ESM a J0
    on the pixel Jacobian's scale."""
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    h, w = frame.shape[:2]
    ys = torch.as_tensor(rng.integers(0, h - CROP, b), device=dev)
    xs = torch.as_tensor(rng.integers(0, w - CROP, b), device=dev)
    ar = torch.arange(CROP, device=dev)
    win = frame[(ys[:, None] + ar)[:, :, None],
                (xs[:, None] + ar)[:, None, :]]
    c = 1 if frame.dim() == 2 else frame.shape[2]
    if c > 1:
        win = win.permute(0, 3, 1, 2)                        # (B, C, Hc, Wc)
    win = win.contiguous()
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
    templ = torch.as_tensor(rng.uniform(0, 255, (b, c, n) if c > 1 else
                                        (b, n)), dtype=torch.float32,
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


def _bound_ms(torch, args, am, esm, kind="linear"):
    """Least time of one launch on the card: the bytes it must move (each
    input read once: the window pixels its points' taps cover (2x2
    linear, 4x4 cubic) in each of its C channels, the warps, points,
    template and J0; each output written once) over the HBM rate,
    against its FLOPs over the float32 rate. Returns (ms, "bytes" |
    "operations", bytes, flops)."""
    win, M0, gens, ph, templ = args
    b, hc, wc = win.shape[0], win.shape[-2], win.shape[-1]
    c = win.shape[1] if win.dim() == 4 else 1
    n = ph.shape[-1]
    q = M0 @ ph
    lo, hi, taps, first = ((0.001, 1.001, 2, 0) if kind == "linear"
                           else (1.001, 2.001, 4, -1))
    x = torch.clamp(q[:, 0] / q[:, 2], lo, wc - hi).floor().long() + first
    y = torch.clamp(q[:, 1] / q[:, 2], lo, hc - hi).floor().long() + first
    i0 = y * wc + x
    idx = torch.cat([i0 + (r * wc + j) for r in range(taps)
                     for j in range(taps)], dim=-1)
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    cover.scatter_(1, idx, True)
    s = 8
    n_out = s + s * s + ((2 * s + 5) if am == "ncc" else 0)
    nbytes = 4 * (c * int(cover.sum()) + b * (9 + 3 * n + c * n)
                  + gens.numel() + (b * s * n if esm else 0) + b * c * n
                  + b * n_out)
    # per point: projection and reciprocal ~20, warp Jacobian 24 per state
    # dim, tap weights (linear ~8, cubic 8 taps of ~14), ESM mean 2 per
    # dim; per channel: the value and derivatives from the taps (linear
    # ~20, cubic 16 taps x 2 sums x 2 + 24), Jm 3 per dim, the residual,
    # 2 per accumulator
    n_acc = s + s * (s + 1) // 2 + ((2 * s + 5) if am == "ncc" else 0)
    weights, sample = (8, 20) if kind == "linear" else (112, 88)
    per_pt = (20 + 24 * s + weights + (2 * s if esm else 0)
              + c * (sample + 3 * s + 1 + 2 * n_acc))
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


def _label(am, esm, mc, kind):
    """The kernel's name in PERF.md's table: K1-K4 by mode, K1c for the
    cubic taps (a mode of every one of them)."""
    base = MODES[(am, esm, mc)]
    if kind == "linear":
        return base
    return "K1c" if base == "K1" else f"{base}+K1c"


def _kernel_specs():
    """(am, esm, C, kind, B) of every kernel-phase row set: each mode at
    its fleet's B with each tap kind, the multi-channel mode at C = 3 (the
    fleet's), 2 and 4."""
    specs = []
    for kind in KINDS:
        for (am, esm, mc), label in MODES.items():
            b = B if label == "K1" else (B_MC if mc else B_SLICE2)
            for c in (MC_CHANNELS if mc else (1,)):
                specs.append((am, esm, c, kind, b))
    return specs


def _kernel_phase(torch, tk, frames, card, dev):
    """Every instantiation against its plain form and timed, at each N;
    `frames` maps a channel count to the scene with that many channels."""
    rows = {}
    for am, esm, c, kind, b in _kernel_specs():
        mc = c > 1
        label = _label(am, esm, mc, kind)
        mode = tk.mode_name(am, esm, mc, kind)
        for n in N_POINTS:
            args, j0 = _chain_inputs(torch, frames[c], n, b, am, esm, dev)
            got = tk.lk_fused_chain_raw(*args, am=am, j0=j0, kind=kind)
            torch.cuda.synchronize()
            want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind)
            err_v = float((got[0] - want[0]).abs().max())
            err_raw = max(_rel_err(torch, a, w)
                          for a, w in zip(got[1:], want[1:]))
            _check(np.isfinite(err_v) and np.isfinite(err_raw),
                   f"{label} {mode} C={c} N={n}: non-finite output")
            _check(err_v <= 1e-3 and err_raw <= 1e-4,
                   f"{label} {mode} C={c} N={n}: cuda vs plain val {err_v}, "
                   f"raw sums {err_raw} of norm")
            row = dict(b=b, c=c, err_v=err_v, err_raw=err_raw)
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
                *args, am=am, j0=j0, kind=kind), 50)
            row["plain_ms"] = _time_ms(torch, lambda: tk.lk_fused_chain_ref(
                *args, am=am, j0=j0, kind=kind), 5)
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _bound_ms(torch, args, am, esm, kind)
            rows[(mode, n, c)] = row
            extra = ("" if am != "ncc" else
                     f", combined g {row['err_g']:.3g} H {row['err_h']:.3g}")
            print(f"{label} {mode} C={c} N={n} B={b}: max|dval| {err_v:.3g}, "
                  f"raw sums {err_raw:.3g} of norm{extra}; cuda "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} "
                  f"GFLOP) ({card})")
            del args, j0
            torch.cuda.empty_cache()
    return rows


def _fleet(torch, key, am, b, card, corners, frame_d, dev, tk, mode,
           windows=WINDOWS, warmup=WARMUP, gf=None, interp="linear_mm"):
    """The fleet's main path: `warmup` updates, then `windows` timed
    windows of STEPS updates; the launch counts are zeroed just before
    and read just after, and `mode` must launch 10 times per update (and,
    given the grid-flow module `gf`, K5 K5_PER_UPDATE times)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    sm = create_tracker(key, am, "8", device=dev, **cfg_of(key, interp))
    fleet = TrackerFleet(sm, donate=True)
    for k in tk.lk_fused_chain_raw.launches:
        tk.lk_fused_chain_raw.launches[k] = 0
    if gf is not None:
        gf.grid_flow.launches = 0
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
    k5 = gf.grid_flow.launches if gf is not None else 0
    n_updates = warmup + windows * STEPS
    _check(launches[mode] == MAX_ITERS * n_updates,
           f"{key}/{am}: {mode} launched {launches[mode]} times in "
           f"{n_updates} updates")
    _check(sum(launches.values()) == launches[mode],
           f"{key}/{am}: other kernel modes launched: {launches}")
    if gf is not None:
        _check(k5 == K5_PER_UPDATE * n_updates,
               f"{key}/{am}: K5 launched {k5} times in {n_updates} updates")
    _check(bool(torch.isfinite(fleet.corners(states)).all()),
           f"{key}/{am}: fleet corners not finite")
    fps = sorted(rates)[len(rates) // 2] if rates else None
    print(f"fleet {key}/{am} {interp} B={b}: "
          + (f"{fps:.1f} frames/s median of {[round(r, 1) for r in rates]}"
             if rates else "untimed")
          + f" ({card}); {mode} launches {launches[mode]} = {MAX_ITERS} x "
          f"{n_updates} updates"
          + (f"; K5 launches {k5} = {K5_PER_UPDATE} x {n_updates} updates"
             if gf is not None else ""))
    return sm, fps, launches[mode], k5


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


def _plain_path_check(sm, key, am, frames, corners, label,
                      interp="linear_mm"):
    """The same trackers on the plain path (CPU tensors: the kernels'
    plain forms) agree with the CUDA path. The grid's RANSAC draw comes
    from a generator on each path's device, so the CPU tracker is handed
    the CUDA tracker's draws."""
    from mtf_tpu_torch import create_tracker
    cpu_sm = create_tracker(key, am, "8", device="cpu", **cfg_of(key, interp))
    if key == "rklt":
        draw = sm.grid_sm._hyp_indices
        cpu_sm.grid_sm._hyp_indices = lambda step, n: draw(step, n).cpu()
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


def _ptxas_k5(log):
    """{points per lane K: (registers, spill store bytes, spill load
    bytes)} of the grid-flow kernel's instantiations (mangled ILi<K>E)."""
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
        if m and name and "grid_flow_kernel" in name:
            k = int(re.search(r"ILi(\d+)E", name).group(1))
            usage[k] = (int(m.group(1)),) + spills
    return usage


def _k5_operands(torch, corners, frame_d, dev):
    """The grid-flow operands of real rklt trackers: one update of the
    rklt fleet on the scene moved by (3, 2) px, each level's call
    recorded (window, points, templates, scale, n, iterations)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.sm import grid as grid_mod
    sm = create_tracker("rklt", "ssd", "8", device=dev, **rklt_cfg())
    st = sm.initialize(frame_d, corners)
    calls, real = [], grid_mod.grid_flow

    def record(win, pts, templ, scale, n, n_iters, zncc=True):
        calls.append((win, pts, templ, scale, n, n_iters))
        return real(win, pts, templ, scale, n, n_iters, zncc)

    grid_mod.grid_flow = record
    try:
        sm.update(st, torch.roll(frame_d, (3, 2), (0, 1)))
    finally:
        grid_mod.grid_flow = real
    torch.cuda.synchronize()
    return calls


def _k5_bound(torch, win, pts, disp, scale, n, n_iters):
    """Least time of one launch: the bytes it must move (the window
    pixels the 4 taps of every point cover, at the start and at the end
    of the level, each counted once; points 8 B and template 4 B per
    point; the scale; disp written) over the HBM rate, against ~60 FLOPs
    per point per iteration over the float32 rate. Returns (ms, "bytes" |
    "operations", bytes, flops)."""
    b, hc, wc = win.shape
    pn = pts.shape[-1]
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    for d in (torch.zeros_like(disp), disp):
        off = (d * scale[:, None, None]).repeat_interleave(n, dim=1)
        x = torch.clamp(pts[:, 0] + off[..., 0], 0.001, wc - 1.001)
        y = torch.clamp(pts[:, 1] + off[..., 1], 0.001, hc - 1.001)
        i00 = y.floor().long() * wc + x.floor().long()
        cover.scatter_(1, torch.cat([i00, i00 + 1, i00 + wc, i00 + wc + 1],
                                    dim=-1), True)
    nbytes = 4 * int(cover.sum()) + b * (12 * pn + 4 + 8 * (pn // n))
    flops = K5_FLOPS_PER_PT_ITER * b * pn * n_iters
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _k5_phase(torch, gf, corners, frame_d, card, dev):
    """K5 at both levels of real rklt trackers: CUDA against the plain
    form on the card, both timed, and the bound."""
    rows = {}
    for win, pts, templ, scale, n, n_iters in _k5_operands(
            torch, corners, frame_d, dev):
        args = (win, pts, templ, scale, n, n_iters)
        got = gf.grid_flow(*args)
        torch.cuda.synchronize()
        want = gf.grid_flow_ref(*args)
        want64 = gf.grid_flow_ref(*(a.double() for a in args[:4]), n,
                                  n_iters)
        d = (got - want).abs().flatten()
        err = float(d.max())
        _check(np.isfinite(err) and bool(torch.isfinite(got).all()),
               f"K5 n={n}: non-finite output")
        row = dict(n=n, iters=n_iters, window=win.shape[-1], err=err,
                   max_disp=float(want.abs().max()),
                   q999=float(torch.quantile(d.double(), 0.999)),
                   n_over=int((d > K5_TOL).sum()), n_patches=d.numel() // 2,
                   cuda_vs_f64=float((got.double() - want64).abs().max()),
                   plain_vs_f64=float((want.double() - want64).abs().max()))
        print(f"K5 n={n}: |ddisp| max {err:.3g}, 99.9% {row['q999']:.3g}, "
              f"{row['n_over']} of {row['n_patches']} patches over {K5_TOL}; "
              f"against float64: cuda {row['cuda_vs_f64']:.3g}, plain "
              f"{row['plain_vs_f64']:.3g}")
        _check(err <= K5_MAX and row["n_over"] <= K5_OVER_SHARE
               * row["n_patches"], f"K5 n={n}: cuda vs plain disp max "
               f"{err} (limit {K5_MAX}), {row['n_over']} patches over "
               f"{K5_TOL} (limit {K5_OVER_SHARE} of {row['n_patches']})")
        row["ms"] = _time_ms(torch, lambda: gf.grid_flow(*args), 50)
        row["plain_ms"] = _time_ms(torch, lambda: gf.grid_flow_ref(*args), 5)
        (row["bound_ms"], row["bound_by"], row["bytes"],
         row["flops"]) = _k5_bound(torch, win, pts, want, scale, n, n_iters)
        level = "1" if n_iters > 1 else "0"
        rows[level] = row
        print(f"K5 level {level} B={win.shape[0]} P={pts.shape[-1] // n} "
              f"n={n} iters={n_iters} window {win.shape[-1]}: max|ddisp| "
              f"{err:.3g} (of max |disp| {row['max_disp']:.3g}) template "
              f"units; cuda {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.3f} GFLOP)"
              f" ({card})")
    _check(sorted(rows) == ["0", "1"], f"K5: levels recorded {sorted(rows)}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    from mtf_tpu_torch.ops.kernels import lk_fused as tk

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    device_kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.load_all(["lk_fused_chain", "grid_flow"])
    build_s = time.perf_counter() - t0
    built = libs["lk_fused_chain"]
    print("build: " + ", ".join(f"{k} nvcc {v.seconds:.2f} s"
                                for k, v in libs.items())
          + f" (side by side, {build_s:.2f} s in all)")
    usage = _ptxas_usage(built.log)
    for am, esm, mc, kind in tk.INSTANTIATIONS:
        label = _label(am, esm, mc, kind)
        _check((am, esm, mc, kind) in usage,
               f"ptxas reported no {label} {kind} instantiation")
        regs, st, ld = usage[(am, esm, mc, kind)]
        print(f"ptxas: {label} {tk.mode_name(am, esm, mc, kind)}: {regs} "
              f"registers, spill stores {st} B, spill loads {ld} B")
    usage_k5 = _ptxas_k5(libs["grid_flow"].log)
    _check(sorted(usage_k5) == [1, 2, 4, 8, 16, 32],
           f"ptxas reported K5 instantiations {sorted(usage_k5)}")
    for k, (regs, st, ld) in sorted(usage_k5.items()):
        print(f"ptxas: K5 grid_flow<{k} points per lane>: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B")

    # -- kernel phase ---------------------------------------------------------
    frame0 = _scene(0)
    frame_d = torch.as_tensor(frame0, device=dev)
    scene3 = _scene3(0)
    frame3_d = torch.as_tensor(scene3, device=dev)
    # C = 2 and 4 windows for K4: the scene's first two channels, and all
    # three with the gray scene as a fourth
    frames = {1: frame_d, 3: frame3_d, 2: frame3_d[..., :2].contiguous(),
              4: torch.cat([frame3_d, frame_d[..., None]], -1)}
    rows = _kernel_phase(torch, tk, frames, card, dev)
    del frames
    corners_rk = _corners(B_RKLT)
    rows_k5 = _k5_phase(torch, gf, corners_rk, frame_d, card, dev)
    torch.cuda.empty_cache()

    # -- slice 1: fclk/ssd fleet, GT leg, plain path -------------------------
    corners = _corners(B)
    sm, fps1, launches_ssd, _ = _fleet(torch, "fclk", "ssd", B, card, corners,
                                    frame_d, dev, tk, "ssd")
    gt1, frames = _gt_leg(sm, frame0, corners, GT_LIMIT_PX, "fclk/ssd")
    _plain_path_check(sm, "fclk", "ssd", frames, corners, "fclk/ssd")
    del sm, frames
    torch.cuda.empty_cache()

    # -- slice 2: esm/ncc fleet, GT leg, plain path --------------------------
    corners2 = _corners(B_SLICE2)
    sm, fps2, launches_ncc_esm, _ = _fleet(torch, "esm", "ncc", B_SLICE2, card,
                                        corners2, frame_d, dev, tk,
                                        "ncc_esm")
    gt2, frames = _gt_leg(sm, frame0, corners2, GT_LIMIT_PX, "esm/ncc")
    plain2 = _plain_path_check(sm, "esm", "ncc", frames, corners2, "esm/ncc")
    del sm, frames

    # -- eslm/ncc: LM on ----------------------------------------------------
    sm, fps_lm, launches_lm, _ = _fleet(torch, "eslm", "ncc", B_SLICE2, card,
                                     corners2, frame_d, dev, tk, "ncc_esm",
                                     windows=1)
    gt_lm, _ = _gt_leg(sm, frame0, corners2, ESLM_GT_LIMIT_PX, "eslm/ncc")
    del sm
    torch.cuda.empty_cache()

    # -- the remaining modes through the entry points --------------------------
    mode_launches = {"ssd": launches_ssd, "ncc_esm": launches_ncc_esm}
    for key, am, mode in (("fclk", "ncc", "ncc"), ("esm", "ssd", "ssd_esm")):
        _, _, mode_launches[mode], _ = _fleet(torch, key, am, B_SLICE2,
                                              card, corners2, frame_d, dev,
                                              tk, mode, windows=0)
    torch.cuda.empty_cache()

    # -- slice 3: rklt/ssd fleet (K5 + ssd_esm), GT leg, plain path ----------
    sm, fps_rk, launches_rk, launches_k5 = _fleet(
        torch, "rklt", "ssd", B_RKLT, card, corners_rk, frame_d, dev, tk,
        "ssd_esm", gf=gf)
    gt_rk, frames = _gt_leg(sm, frame0, corners_rk, RKLT_GT_LIMIT_PX,
                            "rklt/ssd")
    plain_rk = _plain_path_check(sm, "rklt", "ssd", frames, corners_rk,
                                 "rklt/ssd")
    del sm, frames
    torch.cuda.empty_cache()

    # -- slice 4: mcssd fleet (K4) and its gray twin, GT legs, plain path ----
    corners_mc = _corners(B_MC)
    sm, fps_mc, mode_launches["ssd_mc"], _ = _fleet(
        torch, "fclk", "mcssd", B_MC, card, corners_mc, frame3_d, dev, tk,
        "ssd_mc")
    _, fps_twin, _, _ = _fleet(torch, "fclk", "ssd", B_MC, card, corners_mc,
                               frame3_d[..., 0].contiguous(), dev, tk, "ssd")
    print(f"mcssd / gray twin at B={B_MC}: {fps_mc / fps_twin:.3f} "
          f"({fps_mc:.1f} / {fps_twin:.1f} frames/s) ({card})")
    gt_mc, frames = _gt_leg(sm, scene3, corners_mc, MC_GT_LIMIT_PX,
                            "fclk/mcssd")
    plain_mc = _plain_path_check(sm, "fclk", "mcssd", frames, corners_mc,
                                 "fclk/mcssd")
    del sm, frames
    sm, _, launches_fclm, _ = _fleet(torch, "fclm", "mcssd", B_MC, card,
                                     corners_mc, frame3_d, dev, tk, "ssd_mc",
                                     windows=0)
    gt_fclm, _ = _gt_leg(sm, scene3, corners_mc, FCLM_MC_GT_LIMIT_PX,
                         "fclm/mcssd")
    del sm
    torch.cuda.empty_cache()

    # -- slice 4: the headline fleet with cubic taps (K1c) ---------------------
    cubic = {}
    for kind, limit, windows in (("cubic", CUBIC_GT_LIMIT_PX, WINDOWS),
                                 ("cubic_bspl", CUBIC_BSPL_GT_LIMIT_PX, 0)):
        interp = kind + "_mm"
        mode = tk.mode_name("ssd", False, False, kind)
        sm, fps_c, mode_launches[mode], _ = _fleet(
            torch, "fclk", "ssd", B, card, corners, frame_d, dev, tk, mode,
            windows=windows, interp=interp)
        gt_c, frames = _gt_leg(sm, frame0, corners, limit, f"fclk/ssd {interp}")
        plain_c = _plain_path_check(sm, "fclk", "ssd", frames, corners,
                                    f"fclk/ssd {interp}", interp)
        cubic[kind] = {"B": B, "fps": fps_c, "gt_px": gt_c,
                       "plain_path_px": plain_c,
                       "launches": mode_launches[mode]}
        del sm, frames
        torch.cuda.empty_cache()
        # every other mode with this kind's taps, through the entry points
        for key, am, esm, mc in (("fclk", "ncc", False, False),
                                 ("esm", "ssd", True, False),
                                 ("esm", "ncc", True, False),
                                 ("fclk", "mcssd", False, True)):
            mode = tk.mode_name("ncc" if am == "ncc" else "ssd", esm, mc,
                                kind)
            b, crn, frm = ((B_MC, corners_mc, frame3_d) if mc else
                           (B_SLICE2, corners2, frame_d))
            _, _, mode_launches[mode], _ = _fleet(
                torch, key, am, b, card, crn, frm, dev, tk, mode, windows=0,
                interp=interp)
        torch.cuda.empty_cache()

    kernels = []
    for am, esm, mc, kind in tk.INSTANTIATIONS:
        label = _label(am, esm, mc, kind)
        mode = tk.mode_name(am, esm, mc, kind)
        c = 3 if mc else 1
        row = rows[(mode, N_POINTS[-1], c)]
        regs, st, ld = usage[(am, esm, mc, kind)]
        keys = ("ms", "plain_ms", "bound_ms", "err_v", "err_raw") + (
            ("err_g", "err_h") if am == "ncc" else ())
        entry = {
            "name": f"lk_fused_chain[{mode}] ({label})",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": mode_launches[mode],
            "max_abs_err": max(r["err_v"] for (m, _, _), r in rows.items()
                               if m == mode),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"B={row['b']}, " + (f"C={c}, " if mc else "")
                     + f"window {CROP}x{CROP}, N=2500, {kind} taps",
            "registers": regs,
            "spill_stores": st,
            "spill_loads": ld,
            "max_raw_rel_err": max(r["err_raw"] for (m, _, _), r
                                   in rows.items() if m == mode),
            "by_n": {str(n): {k: rows[(mode, n, c)][k] for k in keys}
                     for n in N_POINTS},
        }
        if mc:
            entry["by_channels"] = {
                str(cc): {k: rows[(mode, n, cc)][k] for k in keys}
                for cc in MC_CHANNELS for n in (N_POINTS[-1],)}
        kernels.append(entry)
    k5_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "err", "max_disp",
               "n", "iters", "window")
    t_bytes = sum(r["bytes"] for r in rows_k5.values()) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in rows_k5.values()) / F32_FLOPS_PER_S
    kernels.append({
        "name": "grid_flow (K5)",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": launches_k5,
        "max_abs_err": max(r["err"] for r in rows_k5.values()),
        # one update's two launches (levels 1 and 0)
        "ms": sum(r["ms"] for r in rows_k5.values()),
        "plain_ms": sum(r["plain_ms"] for r in rows_k5.values()),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={B_RKLT}, P=100; level 1 n=16 x 8 iterations in "
                 f"96x96, level 0 n=64 x 1 in {CROP_RKLT}x{CROP_RKLT}",
        "registers": {str(k): v[0] for k, v in sorted(usage_k5.items())},
        "spill_stores": max(v[1] for v in usage_k5.values()),
        "spill_loads": max(v[2] for v in usage_k5.values()),
        "by_level": {lvl: {k: r[k] for k in k5_keys}
                     for lvl, r in sorted(rows_k5.items())},
    })
    print(json.dumps({
        "kernels": kernels,
        "fleets": {"fclk_ssd": {"B": B, "fps": fps1, "gt_px": gt1},
                   "esm_ncc": {"B": B_SLICE2, "fps": fps2, "gt_px": gt2,
                               "plain_path_px": plain2},
                   "eslm_ncc": {"B": B_SLICE2, "fps": fps_lm,
                                "gt_px": gt_lm,
                                "launches": launches_lm},
                   "rklt_ssd": {"B": B_RKLT, "fps": fps_rk, "gt_px": gt_rk,
                                "plain_path_px": plain_rk,
                                "launches": {"ssd_esm": launches_rk,
                                             "grid_flow": launches_k5}},
                   "fclk_mcssd": {"B": B_MC, "fps": fps_mc, "gt_px": gt_mc,
                                  "plain_path_px": plain_mc,
                                  "gray_twin_fps": fps_twin,
                                  "vs_gray_twin": fps_mc / fps_twin,
                                  "launches": mode_launches["ssd_mc"]},
                   "fclm_mcssd": {"B": B_MC, "gt_px": gt_fclm,
                                  "launches": launches_fclm},
                   "fclk_ssd_cubic": cubic["cubic"],
                   "fclk_ssd_cubic_bspl": cubic["cubic_bspl"]},
        "build_s": {k: v.seconds for k, v in libs.items()},
        "wall_s": time.perf_counter() - t_start,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
