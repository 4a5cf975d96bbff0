"""Smoke run of the PyTorch/CUDA port (`mtf_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the first CUDA device: the tracker-fleet
update of the headline benchmark (slice 1: FCLK + SSD + 8-DOF homography,
B = 1280), of the esm_ncc benchmark row (slice 2: ESM + NCC, B = 1024,
and its Levenberg-Marquardt variant eslm), all with 50x50 templates,
10 iterations as 6 + 3 + 1 coarse-to-fine and dense linear sampling from a
144-px window on one 480x640 frame, of the rklt row (slice 3: the
grid tracker with RANSAC, refined by ESM-LM + SSD from a 160-px window,
B = 384), of slice 4: the mcssd row (FCLK + 3-channel SSD, B = 512,
on a 480x640x3 frame, `bench_extra.py:399-472`) and the headline fleet
with cubic taps (`interp="cubic_mm"` / `"cubic_bspl_mm"`), and of slice
5, the grid family: rklt with cubic taps (K5c), Median Flow, the rigid
grid, and the composites grfc, prl and pyr:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernel libraries from `mtf_tpu_torch/csrc/`, one nvcc per
     source, side by side: the chain kernel (15 instantiations: K1 ssd,
     K2 ncc, K3 ssd_esm and ncc_esm, K4 ssd_mc, each with linear taps
     and, as K1c, with cubic and cubic_bspl taps) and the grid-flow
     kernel (18: 6 points-per-lane counts, each as K5 with linear taps
     and K5c with cubic and cubic_bspl taps); prints the build times and
     each instantiation's registers and spills (none allowed in the grid
     flow);
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
  8. K5 and K5c phase: the grid-flow operands of real rklt trackers
     (B = 384, P = 100 patches) on the scene at both pyramid levels
     (level 1: 16 points per patch, 8 iterations, 96-px windows; level
     0: 64 points, 1 iteration, 160-px windows), once per tap kind
     (linear K5; cubic and cubic_bspl K5c, from rklt at `cubic_mm` /
     `cubic_bspl_mm`); the CUDA kernel against its plain form on the
     card (disp within 1e-4 template units on all but 0.1% of patches,
     every one within 1e-2: see K5_TOL), both timed by CUDA events, and
     each level's bound (the window pixels the taps cover, 12 B per
     point, the disp written, over 3.35 TB/s, against
     K5_FLOPS_PER_PT_ITER per point per iteration over 67 TFLOP/s); then
     K5 at Median Flow's shapes the same way: the six calls of one update
     of the mf fleet (B = 384, P = 100, n = 64, 20 iterations on each of
     3 levels with 56, 96 and 160-px windows, forward and back), where a
     component beyond 1e-2 also passes if the kernel is no further from
     the float64 plain form than the float32 one is, plus 1e-2 (see
     K5_MAX), reported as the `mf` row of the K5 entry's `by_level`;
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
 12. slice 5, each fleet through the entry points with its exact launch
     counts per update (`grid_family`), its GT leg and its plain-path
     check (8 trackers, 2 frames, <= 0.05 px, the CPU grids given the
     CUDA grids' RANSAC draws): rklt at `cubic_mm` (B = 384; 3 warm-ups
     and 3 windows of 20 updates; K5c 2 and ssd_esm@cubic 10 per update)
     and at `cubic_bspl_mm` (3 updates); Median Flow `mf`/ssd (B = 384,
     resx = resy = 50, `linear_mm`, crop 160, f2f, fb 2.0 px, 20
     iterations on 3 levels, the median similarity; timed as rklt; K5 6
     per update: 3 levels, forward and back); then 3 updates each of the
     rigid grid at `cubic_mm` (B = 384, K5c 2), grfc (grid then FCLK on
     the rklt grid configuration, B = 384: K5 2, ssd 10), prl (FCLK and
     ESM on the headline configuration, B = 1024: ssd 10, ssd_esm 10)
     and pyr (FCLK on a 3-level pyramid, headline configuration,
     B = 1280: ssd 30). GT limits: GRID_FAMILY_GT_READING_PX.
 GT limits of the slice-4 legs, from the JAX package on the CPU over the
 same legs, first 8 trackers: fclk/mcssd and fclm/mcssd both read
 0.0863 px (per frame 0.103, 0.0879, 0.0955, 0.073, 0.072;
 `scripts/port_mc_reference_leg.py`), fclk/ssd cubic_mm 0.0936 px
 (0.1201, 0.0959, 0.0926, 0.068, 0.0912) and cubic_bspl_mm 0.0395 px
 (0.0477, 0.0387, 0.0421, 0.0308, 0.0384;
 `scripts/port_cubic_reference_leg.py`); all at or under 0.1 px, so
 every limit is 0.2 px.

Launch counts (the chain kernel's per mode, the grid flow's per tap kind)
are set to 0 just before each fleet path and read just after it; every
kernel not named for the path must have launched 0 times. Every failed
check raises, so the script exits non-zero and prints no ok line. The
last line is {"ok": true, "device": {...}}; the line before it is the JSON
summary of the kernels.
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
# Median Flow's calls run 20 iterations, on coarse levels too: there a few
# ill-conditioned patches carry rounding into steps, and the two float32
# forms part further than K5_MAX while the kernel stays nearer the float64
# form than the float32 plain form does (on the card, mf's level-2 forward
# call: one component at 1.7e-2 between the float32 forms, the kernel
# 7.2e-3 from float64, the plain form 2.4e-2). For those calls a component
# beyond K5_MAX passes when |cuda - f64| <= |plain - f64| + K5_MAX, i.e.
# the kernel is as accurate as the plain form; the share rule is K5's
# FLOPs per point per iteration: linear, the offset, clamp, 4 taps and 3
# sums, ZNCC and 5 accumulations (~60); cubic, 8 tap weights of ~14, 16
# taps x 2 sums x 2, 4 rows x 3 sums x 2, plus the rest (~230)
K5_FLOPS_PER_PT_ITER = {"linear": 60, "cubic": 230, "cubic_bspl": 230}
K5_REPLACES = "mtf_tpu/ops/pallas/grid_flow.py:243"
K5C_REPLACES = "mtf_tpu/ops/pallas/grid_flow.py:243 (kind, :94-96, :145-148)"
K5_SOURCE = "mtf_tpu_torch/csrc/grid_flow.cu"
B_MF = 384               # slice 5 Median Flow fleet
B_PYR = 1280             # slice 5 pyramidal fleet (the headline's B)
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
# GT limits of the slice-5 legs: the JAX package on the CPU over the same
# legs, first 8 trackers (scripts/port_grid_family_reference_leg.py); a
# reading at or under 0.1 px gives 0.2 px, a higher one the reading plus
# 0.1 px. Per frame: rklt_cubic 0.1126, 0.0959, 0.1073, 0.0742, 0.0992;
# rklt_cubic_bspl 0.0445, 0.0431, 0.0442, 0.0328, 0.042; mf 0.3852,
# 0.553, 0.531, 0.7036, 1.0719 (a similarity fitted to a projective leg);
# rigid_cubic 1.6539, 1.5884, 1.0791, 1.2741, 1.908 (rigid windows
# against init templates: no warp on the patches); grfc 0.1055, 0.0942,
# 0.1024, 0.0743, 0.0795; prl 0.1127, 0.083, 0.1008, 0.0716, 0.0904; pyr
# 0.1107, 0.0837, 0.0923, 0.0646, 0.0731
GRID_FAMILY_GT_READING_PX = {
    "rklt_cubic": 0.0978, "rklt_cubic_bspl": 0.0413, "mf": 0.6490,
    "rigid_cubic": 1.5007, "grfc": 0.0912, "prl": 0.0917, "pyr": 0.0849}


def gt_limit(reading_px: float) -> float:
    return 0.2 if reading_px <= 0.1 else reading_px + 0.1


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
    return (dict(rklt_cfg(), interp=interp) if key == "rklt"
            else slice_cfg(interp))


def grid_family():
    """The slice-5 fleets: {name: (SM key, AM, B, configuration,
    launches per update by kernel)}; kernels named as in the launch
    counts (chain-kernel modes; `grid_flow@<kind>` for K5 / K5c)."""
    rk_c = dict(rklt_cfg(), interp="cubic_mm")
    return {
        "rklt_cubic": ("rklt", "ssd", B_RKLT, rk_c,
                       {"ssd_esm@cubic": MAX_ITERS, "grid_flow@cubic": 2}),
        "rklt_cubic_bspl": ("rklt", "ssd", B_RKLT,
                            dict(rk_c, interp="cubic_bspl_mm"),
                            {"ssd_esm@cubic_bspl": MAX_ITERS,
                             "grid_flow@cubic_bspl": 2}),
        # Median Flow's own grid: f2f, fb 2.0 px, 20 iterations on each of
        # 3 levels, the median similarity; forward and back per level
        "mf": ("mf", "ssd", B_MF, dict(resx=RES, resy=RES,
                                       interp="linear_mm", crop=CROP_RKLT),
               {"grid_flow@linear": 6}),
        "rigid_cubic": ("grid", "ssd", B_RKLT,
                        dict(rk_c, grid_flow="rigid"),
                        {"grid_flow@cubic": 2}),
        "grfc": ("grfc", "ssd", B_RKLT, rklt_cfg(),
                 {"grid_flow@linear": 2, "ssd": MAX_ITERS}),
        "prl": ("prl", "ssd", B_SLICE2,
                dict(slice_cfg(), members=[("fclk", "ssd", "8"),
                                           ("esm", "ssd", "8")]),
                {"ssd": MAX_ITERS, "ssd_esm": MAX_ITERS}),
        "pyr": ("pyr", "ssd", B_PYR,
                dict(slice_cfg(), pyr_sm="fclk", pyr_n_levels=3),
                {"ssd": 3 * MAX_ITERS}),
    }


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


def _counts(tk, gf):
    """Every kernel's launch count: the chain kernel's per mode, the grid
    flow's per tap kind as `grid_flow@<kind>`."""
    return {**tk.lk_fused_chain_raw.launches,
            **{f"grid_flow@{k}": v for k, v in gf.grid_flow.launches.items()}}


def _zero_counts(tk, gf):
    for counts in (tk.lk_fused_chain_raw.launches, gf.grid_flow.launches):
        for k in counts:
            counts[k] = 0


def _fleet(torch, key, am, b, card, corners, frame_d, dev, tk, gf, expect,
           windows=WINDOWS, warmup=WARMUP, interp="linear_mm", cfg=None,
           label=None):
    """The fleet's main path: `warmup` updates, then `windows` timed
    windows of STEPS updates; the launch counts are zeroed just before
    and read just after, and each kernel must have launched exactly
    `expect[name]` times per update (0 for any name not in `expect`)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    label = label or f"{key}/{am} {interp}"
    sm = create_tracker(key, am, "8", device=dev,
                        **(cfg if cfg is not None else cfg_of(key, interp)))
    fleet = TrackerFleet(sm, donate=True)
    _zero_counts(tk, gf)
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
    counts = _counts(tk, gf)
    n_updates = warmup + windows * STEPS
    for name, got in counts.items():
        _check(got == expect.get(name, 0) * n_updates,
               f"{label}: {name} launched {got} times in {n_updates} updates "
               f"(expected {expect.get(name, 0)} per update)")
    _check(bool(torch.isfinite(fleet.corners(states)).all()),
           f"{label}: fleet corners not finite")
    fps = sorted(rates)[len(rates) // 2] if rates else None
    print(f"fleet {label} B={b}: "
          + (f"{fps:.1f} frames/s median of {[round(r, 1) for r in rates]}"
             if rates else "untimed")
          + f" ({card}); launches "
          + ", ".join(f"{k} {counts[k]} = {v} x {n_updates} updates"
                      for k, v in expect.items()))
    return sm, fps, {k: counts[k] for k in expect}


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
                      interp="linear_mm", cfg=None):
    """The same trackers on the plain path (CPU tensors: the kernels'
    plain forms) agree with the CUDA path. The grid's RANSAC draw comes
    from a generator on each path's device, so each CPU grid is handed
    its CUDA twin's draws."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.sm.grid import GridTracker
    cfg = cfg if cfg is not None else cfg_of(key, interp)
    cpu_sm = create_tracker(key, am, "8", device="cpu", **cfg)
    cuda_grids = [m for m in sm.modules() if isinstance(m, GridTracker)]
    cpu_grids = [m for m in cpu_sm.modules() if isinstance(m, GridTracker)]
    for g_cuda, g_cpu in zip(cuda_grids, cpu_grids):
        g_cpu._hyp_indices = (lambda draw: lambda step, n: draw(step, n).cpu()
                              )(g_cuda._hyp_indices)
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
    """{(points per lane K, tap kind): (registers, spill store bytes, spill
    load bytes)} of the grid-flow kernel's instantiations (mangled
    ILi<K>ELi<kind>E)."""
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
            k, kind = re.search(r"ILi(\d+)ELi(\d)E", name).groups()
            usage[(int(k), KINDS[int(kind)])] = (int(m.group(1)),) + spills
    return usage


def _k5_operands(torch, corners, frame_d, dev, key="rklt", cfg=None):
    """The grid-flow operands of real trackers (rklt in its row's
    configuration by default): one update of the `key` fleet on the scene
    moved by (3, 2) px, each grid-flow call recorded in order (window,
    points, templates, scale, n, iterations, kind)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.sm import grid as grid_mod
    sm = create_tracker(key, "ssd", "8", device=dev,
                        **(cfg if cfg is not None else cfg_of(key)))
    st = sm.initialize(frame_d, corners)
    calls, real = [], grid_mod.grid_flow

    def record(win, pts, templ, scale, n, n_iters, zncc=True,
               kind="linear"):
        calls.append((win, pts, templ, scale, n, n_iters, kind))
        return real(win, pts, templ, scale, n, n_iters, zncc, kind)

    grid_mod.grid_flow = record
    try:
        sm.update(st, torch.roll(frame_d, (3, 2), (0, 1)))
    finally:
        grid_mod.grid_flow = real
    torch.cuda.synchronize()
    return calls


def _k5_bound(torch, win, pts, disp, scale, n, n_iters, kind):
    """Least time of one launch: the bytes it must move (the window
    pixels the taps of every point cover (2x2 linear, 4x4 cubic), at the
    start and at the end of the level, each counted once; points 8 B and
    template 4 B per point; the scale; disp written) over the HBM rate,
    against K5_FLOPS_PER_PT_ITER per point per iteration over the float32
    rate. Returns (ms, "bytes" | "operations", bytes, flops)."""
    b, hc, wc = win.shape
    pn = pts.shape[-1]
    lo, hi, taps, first = ((0.001, 1.001, 2, 0) if kind == "linear"
                           else (1.001, 2.001, 4, -1))
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    for d in (torch.zeros_like(disp), disp):
        off = (d * scale[:, None, None]).repeat_interleave(n, dim=1)
        x = torch.clamp(pts[:, 0] + off[..., 0], lo, wc - hi)
        y = torch.clamp(pts[:, 1] + off[..., 1], lo, hc - hi)
        i0 = (y.floor().long() + first) * wc + x.floor().long() + first
        cover.scatter_(1, torch.cat([i0 + (r * wc + j) for r in range(taps)
                                     for j in range(taps)], dim=-1), True)
    nbytes = 4 * int(cover.sum()) + b * (12 * pn + 4 + 8 * (pn // n))
    flops = K5_FLOPS_PER_PT_ITER[kind] * b * pn * n_iters
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _k5_check(torch, gf, call, name, card, f64_clause=False):
    """One recorded grid-flow call: the CUDA kernel against its plain form
    on the card under K5's rule (K5_TOL, K5_OVER_SHARE, K5_MAX), both timed
    by CUDA events, and the launch's bound. With `f64_clause` (Median
    Flow's 20-iteration calls) a disp component beyond K5_MAX of the
    float32 plain form also passes when the kernel is no further from the
    float64 plain form than the float32 one is, plus K5_MAX (see the note
    at K5_MAX). Returns its row."""
    win, pts, templ, scale, n, n_iters, kind = call
    args = (win, pts, templ, scale, n, n_iters, True, kind)
    got = gf.grid_flow(*args)
    torch.cuda.synchronize()
    want = gf.grid_flow_ref(*args)
    want64 = gf.grid_flow_ref(*(a.double() for a in args[:4]), *args[4:])
    d = (got - want).abs().flatten()
    d64 = (got.double() - want64).abs().flatten()
    p64 = (want.double() - want64).abs().flatten()
    err = float(d.max())
    _check(np.isfinite(err) and bool(torch.isfinite(got).all()),
           f"{name}: non-finite output")
    far = d > K5_MAX
    by_f64 = far & (d64 <= p64 + K5_MAX) if f64_clause else \
        torch.zeros_like(far)
    worst = torch.argsort(d, descending=True)[:3]
    row = dict(n=n, iters=n_iters, window=win.shape[-1], err=err,
               kind=kind, max_disp=float(want.abs().max()),
               q999=float(torch.quantile(d.double(), 0.999)),
               n_over=int((d > K5_TOL).sum()), n_patches=d.numel() // 2,
               n_by_f64=int(by_f64.sum()),
               cuda_vs_f64=float(d64.max()), plain_vs_f64=float(p64.max()),
               worst=[[float(d[i]), float(d64[i]), float(p64[i])]
                      for i in worst.tolist()])
    worst_s = [[float(f"{x:.3g}") for x in w] for w in row["worst"]]
    print(f"{name}: |ddisp| max {err:.3g}, 99.9% {row['q999']:.3g}, "
          f"{row['n_over']} of {row['n_patches']} patches over {K5_TOL}; "
          f"against float64: cuda {row['cuda_vs_f64']:.3g}, plain "
          f"{row['plain_vs_f64']:.3g}; worst components (cuda - plain, "
          f"cuda - f64, plain - f64): {worst_s}"
          + (f"; {row['n_by_f64']} beyond {K5_MAX} passed by the float64 "
             f"clause" if f64_clause else ""))
    _check(bool((~far | by_f64).all()) and row["n_over"] <= K5_OVER_SHARE
           * row["n_patches"], f"{name}: cuda vs plain disp max {err} "
           f"(limit {K5_MAX}" + (", or no further than the float32 plain "
           "form from the float64 one, plus the limit" if f64_clause
           else "") + f"), {row['n_over']} patches over {K5_TOL} "
           f"(limit {K5_OVER_SHARE} of {row['n_patches']})")
    row["ms"] = _time_ms(torch, lambda: gf.grid_flow(*args), 50)
    row["plain_ms"] = _time_ms(torch, lambda: gf.grid_flow_ref(*args), 5)
    (row["bound_ms"], row["bound_by"], row["bytes"],
     row["flops"]) = _k5_bound(torch, win, pts, want, scale, n, n_iters,
                               kind)
    print(f"{name} B={win.shape[0]} P={pts.shape[-1] // n} n={n} "
          f"iters={n_iters} window {win.shape[-1]}: max|ddisp| {err:.3g} "
          f"(of max |disp| {row['max_disp']:.3g}) template units; cuda "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.3f} GFLOP) "
          f"({card})")
    return row


def _k5_phase(torch, gf, corners, frame_d, card, dev, interp="linear_mm"):
    """The grid-flow kernel (K5, or K5c with `interp`'s cubic taps) at
    both levels of real rklt trackers (`_k5_check`). Returns {level:
    row}."""
    rows = {}
    for call in _k5_operands(torch, corners, frame_d, dev,
                             cfg=cfg_of("rklt", interp)):
        kind, n_iters = call[6], call[5]
        level = "1" if n_iters > 1 else "0"
        name = ("K5" if kind == "linear" else f"K5c {kind}") + \
            f" rklt level {level}"
        rows[level] = _k5_check(torch, gf, call, name, card)
    _check(sorted(rows) == ["0", "1"], f"K5 {interp}: levels recorded "
           f"{sorted(rows)}")
    return rows


def _k5_mf_phase(torch, gf, corners, frame_d, card, dev):
    """K5 at Median Flow's shapes: the six grid-flow calls of one update
    of the mf fleet (3 levels, 20 iterations each, coarse to fine, forward
    on the new frame, then back on the previous one), each through
    `_k5_check`. Returns the row of the update: ms, plain_ms and the bound
    summed over the six launches, the largest error, and each call's row
    under `calls`."""
    key, _, _, cfg, _ = grid_family()["mf"]
    calls = _k5_operands(torch, corners, frame_d, dev, key=key, cfg=cfg)
    levels = len(calls) // 2
    _check(len(calls) == 6, f"mf: {len(calls)} grid-flow calls per update "
           f"(expected 6)")
    rows = {}
    for i, call in enumerate(calls):
        label = f"{'fwd' if i < levels else 'back'} {levels - 1 - i % levels}"
        rows[label] = _k5_check(torch, gf, call, f"K5 mf {label}", card,
                                f64_clause=True)
    t_bytes = sum(r["bytes"] for r in rows.values()) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in rows.values()) / F32_FLOPS_PER_S
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "err", "q999",
            "n_over", "n_patches", "n_by_f64", "cuda_vs_f64",
            "plain_vs_f64", "worst", "max_disp", "n", "iters", "window")
    row = {"ms": sum(r["ms"] for r in rows.values()),
           "plain_ms": sum(r["plain_ms"] for r in rows.values()),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "err": max(r["err"] for r in rows.values()),
           "shape": f"B={len(corners)}, P=100, n=64, 20 iterations; windows "
                    f"{[r['window'] for r in rows.values()][:levels]} "
                    f"(levels {levels - 1}..0), forward and back",
           "calls": {k: {kk: r[kk] for kk in keys} for k, r in rows.items()}}
    print(f"K5 mf update (6 launches) B={len(corners)}: cuda {row['ms']:.4f}"
          f" ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
          f" ms ({row['bound_by']}), max|ddisp| {row['err']:.3g} ({card})")
    return row


def _k5_entry(rows_k5, kind, launches, usage_k5, mf_row=None):
    """The kernels-line entry of the grid flow with `kind` taps: one rklt
    update's two launches (levels 1 and 0) summed; `launches` {fleet:
    count} of every main-path fleet with these taps, summed; Median Flow's
    update (`_k5_mf_phase`) beside the rklt levels in `by_level`."""
    t_bytes = sum(r["bytes"] for r in rows_k5.values()) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in rows_k5.values()) / F32_FLOPS_PER_S
    mine = {k: v for (k, kd), v in usage_k5.items() if kd == kind}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "err", "max_disp",
            "n", "iters", "window")
    by_level = {lvl: {k: r[k] for k in keys}
                for lvl, r in sorted(rows_k5.items())}
    errs = [r["err"] for r in rows_k5.values()]
    if mf_row is not None:
        by_level["mf"] = mf_row
        errs.append(mf_row["err"])
    return {
        "name": "grid_flow (K5)" if kind == "linear"
                else f"grid_flow[{kind}] (K5c)",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES if kind == "linear" else K5C_REPLACES,
        "launches": sum(launches.values()),
        "launches_by_fleet": launches,
        "max_abs_err": max(errs),
        "ms": sum(r["ms"] for r in rows_k5.values()),
        "plain_ms": sum(r["plain_ms"] for r in rows_k5.values()),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={B_RKLT}, P=100; level 1 n=16 x 8 iterations in "
                 f"96x96, level 0 n=64 x 1 in {CROP_RKLT}x{CROP_RKLT}, "
                 f"{kind} taps",
        "registers": {str(k): v[0] for k, v in sorted(mine.items())},
        "spill_stores": max(v[1] for v in mine.values()),
        "spill_loads": max(v[2] for v in mine.values()),
        "by_level": by_level,
    }


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
    _check(sorted(usage_k5) == sorted(gf.INSTANTIATIONS),
           f"ptxas reported grid-flow instantiations {sorted(usage_k5)}")
    for (k, kind), (regs, st, ld) in sorted(usage_k5.items(),
                                            key=lambda kv: kv[0][::-1]):
        name = "K5" if kind == "linear" else "K5c"
        print(f"ptxas: {name} grid_flow<{k} points per lane, {kind}>: {regs} "
              f"registers, spill stores {st} B, spill loads {ld} B")
        _check(st == 0 and ld == 0, f"{name} grid_flow<{k}, {kind}> spills")

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
    rows_k5 = {kind: _k5_phase(torch, gf, corners_rk, frame_d, card, dev,
                               f"{kind}_mm") for kind in KINDS}
    row_k5_mf = _k5_mf_phase(torch, gf, corners_rk, frame_d, card, dev)
    torch.cuda.empty_cache()

    # -- slice 1: fclk/ssd fleet, GT leg, plain path -------------------------
    corners = _corners(B)
    sm, fps1, got = _fleet(torch, "fclk", "ssd", B, card, corners, frame_d,
                           dev, tk, gf, {"ssd": MAX_ITERS})
    launches = dict(got)
    gt1, frames = _gt_leg(sm, frame0, corners, GT_LIMIT_PX, "fclk/ssd")
    _plain_path_check(sm, "fclk", "ssd", frames, corners, "fclk/ssd")
    del sm, frames
    torch.cuda.empty_cache()

    # -- slice 2: esm/ncc fleet, GT leg, plain path --------------------------
    corners2 = _corners(B_SLICE2)
    sm, fps2, got = _fleet(torch, "esm", "ncc", B_SLICE2, card, corners2,
                           frame_d, dev, tk, gf, {"ncc_esm": MAX_ITERS})
    launches.update(got)
    gt2, frames = _gt_leg(sm, frame0, corners2, GT_LIMIT_PX, "esm/ncc")
    plain2 = _plain_path_check(sm, "esm", "ncc", frames, corners2, "esm/ncc")
    del sm, frames

    # -- eslm/ncc: LM on ----------------------------------------------------
    sm, fps_lm, got = _fleet(torch, "eslm", "ncc", B_SLICE2, card, corners2,
                             frame_d, dev, tk, gf, {"ncc_esm": MAX_ITERS},
                             windows=1)
    launches_lm = got["ncc_esm"]
    gt_lm, _ = _gt_leg(sm, frame0, corners2, ESLM_GT_LIMIT_PX, "eslm/ncc")
    del sm
    torch.cuda.empty_cache()

    # -- the remaining modes through the entry points --------------------------
    for key, am, mode in (("fclk", "ncc", "ncc"), ("esm", "ssd", "ssd_esm")):
        _, _, got = _fleet(torch, key, am, B_SLICE2, card, corners2, frame_d,
                           dev, tk, gf, {mode: MAX_ITERS}, windows=0)
        launches.update(got)
    torch.cuda.empty_cache()

    # -- slice 3: rklt/ssd fleet (K5 + ssd_esm), GT leg, plain path ----------
    sm, fps_rk, got = _fleet(torch, "rklt", "ssd", B_RKLT, card, corners_rk,
                             frame_d, dev, tk, gf,
                             {"ssd_esm": MAX_ITERS,
                              "grid_flow@linear": K5_PER_UPDATE})
    launches_rk, launches_k5 = got["ssd_esm"], got["grid_flow@linear"]
    gt_rk, frames = _gt_leg(sm, frame0, corners_rk, RKLT_GT_LIMIT_PX,
                            "rklt/ssd")
    plain_rk = _plain_path_check(sm, "rklt", "ssd", frames, corners_rk,
                                 "rklt/ssd")
    del sm, frames
    torch.cuda.empty_cache()

    # -- slice 4: mcssd fleet (K4) and its gray twin, GT legs, plain path ----
    corners_mc = _corners(B_MC)
    sm, fps_mc, got = _fleet(torch, "fclk", "mcssd", B_MC, card, corners_mc,
                             frame3_d, dev, tk, gf, {"ssd_mc": MAX_ITERS})
    launches.update(got)
    _, fps_twin, _ = _fleet(torch, "fclk", "ssd", B_MC, card, corners_mc,
                            frame3_d[..., 0].contiguous(), dev, tk, gf,
                            {"ssd": MAX_ITERS}, label="fclk/ssd gray twin")
    print(f"mcssd / gray twin at B={B_MC}: {fps_mc / fps_twin:.3f} "
          f"({fps_mc:.1f} / {fps_twin:.1f} frames/s) ({card})")
    gt_mc, frames = _gt_leg(sm, scene3, corners_mc, MC_GT_LIMIT_PX,
                            "fclk/mcssd")
    plain_mc = _plain_path_check(sm, "fclk", "mcssd", frames, corners_mc,
                                 "fclk/mcssd")
    del sm, frames
    sm, _, got = _fleet(torch, "fclm", "mcssd", B_MC, card, corners_mc,
                        frame3_d, dev, tk, gf, {"ssd_mc": MAX_ITERS},
                        windows=0)
    launches_fclm = got["ssd_mc"]
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
        sm, fps_c, got = _fleet(torch, "fclk", "ssd", B, card, corners,
                                frame_d, dev, tk, gf, {mode: MAX_ITERS},
                                windows=windows, interp=interp)
        launches.update(got)
        gt_c, frames = _gt_leg(sm, frame0, corners, limit,
                               f"fclk/ssd {interp}")
        plain_c = _plain_path_check(sm, "fclk", "ssd", frames, corners,
                                    f"fclk/ssd {interp}", interp)
        cubic[kind] = {"B": B, "fps": fps_c, "gt_px": gt_c,
                       "plain_path_px": plain_c, "launches": launches[mode]}
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
            _, _, got = _fleet(torch, key, am, b, card, crn, frm, dev, tk, gf,
                               {mode: MAX_ITERS}, windows=0, interp=interp)
            launches.update(got)
        torch.cuda.empty_cache()

    # -- slice 5: the grid family (K5c, flows, Median Flow, composites) -------
    family = {}
    k5_launches = {kind: {} for kind in KINDS}
    k5_launches["linear"]["rklt"] = launches_k5
    for name, (key, am, b, cfg, expect) in grid_family().items():
        # the two headline legs of slice 5 are timed; the rest run 3
        # updates through the entry points
        windows = WINDOWS if name in ("rklt_cubic", "mf") else 0
        crn = corners_rk if b == B_RKLT else _corners(b)
        label = f"{name} ({key}/{am})"
        sm, fps, got = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                              gf, expect, windows=windows, cfg=cfg,
                              label=label)
        for k, v in got.items():
            if k.startswith("grid_flow@"):
                k5_launches[k.split("@")[1]][name] = v
        reading = GRID_FAMILY_GT_READING_PX[name]
        gt, frames = _gt_leg(sm, frame0, crn, gt_limit(reading), label)
        plain = _plain_path_check(sm, key, am, frames, crn, label, cfg=cfg)
        family[name] = {"B": b, "fps": fps, "gt_px": gt,
                        "gt_limit_px": gt_limit(reading),
                        "jax_cpu_reading_px": reading,
                        "plain_path_px": plain, "launches": got}
        del sm, frames
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
            "launches": launches[mode],
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
    for kind in KINDS:
        kernels.append(_k5_entry(rows_k5[kind], kind, k5_launches[kind],
                                 usage_k5,
                                 row_k5_mf if kind == "linear" else None))
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
                                  "launches": launches["ssd_mc"]},
                   "fclm_mcssd": {"B": B_MC, "gt_px": gt_fclm,
                                  "launches": launches_fclm},
                   "fclk_ssd_cubic": cubic["cubic"],
                   "fclk_ssd_cubic_bspl": cubic["cubic_bspl"],
                   **family},
        "build_s": {k: v.seconds for k, v in libs.items()},
        "wall_s": time.perf_counter() - t_start,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
