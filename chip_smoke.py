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
grid, and the composites grfc, prl and pyr, and of slice 6: the matrix
SSMs other than the homography on the chain kernel at S = 2-6, the
sub-tracker grid, and the last two TPU kernels, K4b (blurred taps) and K6
(`lk_fused_gn_t`):

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernel libraries from `mtf_tpu_torch/csrc/`, one nvcc per
     library, side by side: the chain kernel once per state size S in
     STATE_DIMS (30 instantiations each: K1 ssd, K2 ncc, K3 ssd_esm and
     ncc_esm, K4 ssd_mc, each with linear taps and, as K1c, with cubic
     and cubic_bspl taps, each with plain and, as K4b, blurred taps), K6
     (18: 6 state sizes x 3 tap kinds) and the grid-flow kernel (18: 6
     points-per-lane counts, each as K5 with linear taps and K5c with
     cubic and cubic_bspl taps); prints the build times and each
     instantiation's registers and spills (none allowed anywhere; the
     S = 8 plain-tap instantiations must keep REGS_S8);
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
 12. slice 6 kernel phase (run right after 3): every chain instantiation
     at S = 2, 3, 4, 5 and 6 (the mode's fleet's B, N = 2500, SSD-MC at
     C = 3) against its plain form under 3's rules (at S != 8 only, a
     tracker's raw sum beyond RAW_REL of its norm passes within ROUND_K
     float32 epsilons of its rounding scale more; each row that needs
     that is rerun with PLANTED_FAULTS, which the rule must reject: see
     RAW_REL); K4b at blur 2, 3 and 4 (K4B_CASES) in every mode and kind
     at S = 8 and 6; K6 at every S and kind (the same rule), with and
     without the 144-px crop (B = 1280, N = 2500, 176-px windows); the
     K1-vs-K6 oracle (`_oracle_phase`) at S = 2, 6 and 8; ssd:s2 at the
     sub-tracker grid's own shapes (`_subgrid_phase`: B = 38,400
     sub-trackers, N = 16 and 64, 32-px windows); each timed by CUDA
     events against its plain form, with its bound;
 13. slice 5, each fleet through the entry points with its exact launch
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
 14. slice 6 fleets (`ssm_family`), each with its exact launch counts per
     update, its GT leg and its plain-path check (rklt/ssd/6's tracker 1,
     on a pixel boundary, to PLAIN_PATH_BOUNDARY_TOL_PX): fclk/ssd on the
     affine SSM ("6", B = 1280; 3 warm-ups and 3 windows of 20 updates; ssd:s6
     10 per update), esm/ncc on the similitude ("4", B = 1024;
     ncc_esm:s4 10), rklt/ssd on the affine (B = 384, crop 160; the
     affine DLT in RANSAC; ssd_esm:s6 10 and K5 2), and the sub-tracker
     grid (`grid_sm="fclk"`, the factory's sub-grid defaults: translation
     sub-trackers on 8x8 SSD templates, B = 384 trackers of 100, so
     38,400 sub-trackers, crop 32, one stride-2 coarse phase, see
     SUBGRID_COARSE; ssd:s2 10); then 3 updates of fclk/ssd (B = 1280)
     on every other SSM key (OTHER_SSM_KEYS). GT limits:
     SSM_FAMILY_GT_READING_PX.
 GT limits of the slice-4 legs, from the JAX package on the CPU over the
 same legs, first 8 trackers: fclk/mcssd and fclm/mcssd both read
 0.0863 px (per frame 0.103, 0.0879, 0.0955, 0.073, 0.072;
 `scripts/port_mc_reference_leg.py`), fclk/ssd cubic_mm 0.0936 px
 (0.1201, 0.0959, 0.0926, 0.068, 0.0912) and cubic_bspl_mm 0.0395 px
 (0.0477, 0.0387, 0.0421, 0.0308, 0.0384;
 `scripts/port_cubic_reference_leg.py`); all at or under 0.1 px, so
 every limit is 0.2 px.

Launch counts (the chain kernel's per mode and state size, K6's per state
size and kind, the grid flow's per tap kind) are set to 0 just before
each fleet path and read just after it; every
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
# trackers of a fleet's plain-path check known to sit on a pixel boundary
# of a float32 form, held to PLAIN_PATH_BOUNDARY_TOL_PX: {fleet: {index:
# why}}. rklt_ssd_6's tracker 1: 0.0479 px at frame 1 in every run on the
# NVIDIA H100 80GB HBM3 (700.00 W), its J0 and H0 equal on both devices;
# a grid point on a pixel boundary flips K5's dense derivative and meets
# a RANSAC inlier at the threshold (PERF.md, PR 6); the other 7 read at
# most 3.1e-5 px
PLAIN_PATH_BOUNDARY = {"rklt_ssd_6": {1: "K5 pixel-boundary flip at a "
                                         "RANSAC threshold"}}
PLAIN_PATH_BOUNDARY_TOL_PX = 0.5
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
# state sizes of the matrix SSMs, each its own build of the chain kernel,
# and an SSM key of each (chain_inputs' warps, the K6 operands)
STATE_DIMS = (2, 3, 4, 5, 6, 8)
SSM_OF_S = {2: "2", 3: "3s", 4: "4", 5: "5", 6: "6", 8: "8"}
NEW_S = (2, 3, 4, 5, 6)
# the registers ptxas gives the S = 8 plain-tap instantiations, (linear,
# cubic, cubic_bspl) per mode: the blurred taps and the other state sizes
# leave them as they were (NVIDIA H100 80GB HBM3, CUDA 12.8)
REGS_S8 = {("ssd", False, False): (180, 209, 195),
           ("ncc", False, False): (202, 227, 215),
           ("ssd", True, False): (182, 212, 209),
           ("ncc", True, False): (207, 236, 228),
           ("ssd", False, True): (182, 198, 195)}
# raw chain sums: within RAW_REL of their norm of the float32 plain form,
# per tracker. At S = 8 that is the whole rule. At the other state sizes a
# tracker's g (or NCC's [Σ Jm v]) can cancel to a norm near the float32
# rounding of its terms, and then the two float32 forms part by more (on
# the card, ssd:s2@cubic at B = 1280: 6.1e-4 of the norm; on the sub-
# grid's 38,400 trackers at N = 16: 2.7e-4). There a sum also passes
# within RAW_REL of its norm plus ROUND_K float32 epsilons of its rounding
# scale, its terms in absolute value summed (`chain_sum_scales`): an a
# priori bound on two float32 forms whose sums of N terms each round by
# ~(N / 256 + log2 256 ≈ 18 serial and tree adds in the kernel, log2 N ≈
# 12 pairwise in PyTorch) plus ~8 roundings per term, each form within
# ~26 epsilons of the scale, the two within 52. Every row that needs the
# floor is also run with two planted faults (PLANTED_FAULTS), which the
# rule must reject
RAW_REL = 1e-4
EPS32 = 2.0 ** -24
ROUND_K = 64
# the planted faults: the window rounded to bfloat16 (the TPU kernel's
# layout) and the first generator (K6: the first state dim's Jacobian rows)
# scaled by 1 + 1e-3, which leaves val as it is and moves only the sums
PLANTED_FAULTS = ("bf16 window", "generator 0 x 1.001")
# K4b: each blur at the point count of the coarse phase whose stride it
# blurs (blur 4 at N = 169, blur 2 at N = 625) and blur 3 between, at
# S = 8 and 6, in every mode and kind
K4B_CASES = ((2, 625), (3, 625), (4, 169))
K4B_S = (8, 6)
K4B_REPLACES = ("mtf_tpu/ops/pallas/lk_fused.py:442 (blur > 1, :258-262; "
                "taps mtf_tpu/ops/pallas/dense_sample.py:27-48)")
GN_REPLACES = ("mtf_tpu/ops/pallas/lk_fused.py:129 (lk_fused_gn_t :167, "
               "body _kernel :71)")
GN_SOURCE = "mtf_tpu_torch/csrc/lk_fused_gn.cu"
ORACLE_KEYS = ("2", "6", "8")
SUBGRID_CROP = 32        # the sub-trackers' window (8x8 templates)
# the sub-trackers' coarse phase: stride 2 only. A stride-4 phase leaves
# 2x2 points of an 8x8 template, whose translation Hessian can be near
# singular: a sub-tracker's step then leaves the frame, and the grid's DLT
# refit, which normalises all points unweighted, turns NaN (in the JAX
# package too: its CPU leg reads NaN with the headline's 4-and-2 schedule)
SUBGRID_COARSE = ((2, 3),)
# fclk/ssd on every SSM key not among the slice-6 fleets: 3 updates each
OTHER_SSM_KEYS = ("2", "3s", "3", "l3", "4s", "5", "l6", "l8", "sl3", "c8")
# GT readings of the slice-6 legs: the JAX package on the CPU over the
# same legs, first 8 trackers (scripts/port_ssm_reference_leg.py)
# Per frame: fclk_ssd_6 0.0948, 0.1069, 0.095, 0.0782, 0.0754; esm_ncc_4
# 0.0785, 0.0859, 0.0776, 0.058, 0.0575; rklt_ssd_6 0.0934, 0.1033,
# 0.0915, 0.0675, 0.0737; subgrid 0.3009, 0.2298, 0.1761, 0.2012, 0.2715
# (translation sub-trackers on 8x8 templates under a projective leg)
SSM_FAMILY_GT_READING_PX = {"fclk_ssd_6": 0.0901, "esm_ncc_4": 0.0715,
                            "rklt_ssd_6": 0.0859, "subgrid": 0.2359}
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


def ssm_family():
    """The slice-6 fleets: {name: (SM key, AM, SSM key, B, configuration,
    launches per update by kernel, timed)}."""
    return {
        "fclk_ssd_6": ("fclk", "ssd", "6", B, slice_cfg(),
                       {"ssd:s6": MAX_ITERS}, True),
        "esm_ncc_4": ("esm", "ncc", "4", B_SLICE2, slice_cfg(),
                      {"ncc_esm:s4": MAX_ITERS}, False),
        "rklt_ssd_6": ("rklt", "ssd", "6", B_RKLT, rklt_cfg(),
                       {"ssd_esm:s6": MAX_ITERS, "grid_flow@linear": 2},
                       False),
        # the factory's sub-grid defaults: grid_ssm "2", grid_am "ssd",
        # grid_patch_res 8; B x 100 sub-trackers, on the parent homography;
        # the sub-trackers take SUBGRID_COARSE (see there)
        "subgrid": ("grid", "ssd", "8", B_RKLT,
                    dict(slice_cfg(), crop=SUBGRID_CROP, grid_sm="fclk",
                         coarse_pt_iters=SUBGRID_COARSE),
                    {"ssd:s2": MAX_ITERS}, False),
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


def _ptxas(log, kernel):
    """[(mangled name, registers, spill store bytes, spill load bytes)] of
    every function whose name matches the regex `kernel`, from
    `nvcc -Xptxas -v` output."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(kernel, name):
            out.append((name, int(m.group(1))) + spills)
    return out


def _ptxas_usage(log):
    """{(am, esm, mc, kind, blurred): (registers, spill store bytes, spill
    load bytes)} of each chain-kernel instantiation of one library (one
    S): the template's bool arguments mangle as Lb0E / Lb1E, the tap kind
    as Li<k>E; the blurred taps are `lk_fused_chain_blur_kernel`."""
    usage = {}
    for name, *use in _ptxas(log, r"lk_fused_chain_(blur_)?kernel"):
        flags = re.findall(r"Lb([01])E", name)
        kind = KINDS[int(re.search(r"Li(\d)E", name).group(1))]
        usage[("ncc" if flags[0] == "1" else "ssd", flags[1] == "1",
               flags[2] == "1", kind, "blur_kernel" in name)] = tuple(use)
    return usage


def _ptxas_gn(log):
    """{(S, kind): (registers, spill store bytes, spill load bytes)} of
    K6's instantiations (mangled ILi<S>ELi<kind>E)."""
    usage = {}
    for name, *use in _ptxas(log, "lk_fused_gn_kernel"):
        st, kind = re.search(r"ILi(\d)ELi(\d)E", name).groups()
        usage[(int(st), KINDS[int(kind)])] = tuple(use)
    return usage


def _chain_inputs(torch, frame, n, b, am, esm, dev, seed=2, ssm_key="8",
                  size=CROP, span=CROP):
    """Chain-kernel operands at the fleets' shapes: windows cropped from
    the scene at random places ((B, C, 144, 144) channel-stacked for an
    (H, W, C) frame; `size` px square), random near-identity warps of SSM
    `ssm_key` (the homography by default) of the stride-decimated 50x50
    template grid (laid out for a `span`-px window: 80/144 of it wide, in
    its middle), random templates ((B, C, N) for C channels; for NCC
    centred and of unit norm), and for ESM a J0 (B, S, N) on the pixel
    Jacobian's scale."""
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    h, w = frame.shape[:2]
    ys = torch.as_tensor(rng.integers(0, h - size, b), device=dev)
    xs = torch.as_tensor(rng.integers(0, w - size, b), device=dev)
    ar = torch.arange(size, device=dev)
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
    ssm = get_ssm(ssm_key, device=dev)
    s = ssm.dof
    state = torch.as_tensor(rng.normal(0, 0.02, (b, s)), dtype=torch.float32,
                            device=dev)
    sc = span / CROP
    norm = torch.tensor([[80.0 * sc, 0, 72 * sc], [0, 80.0 * sc, 72 * sc],
                         [0, 0, 1]], device=dev)
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
        j0 = torch.as_tensor(rng.normal(0, 30.0, (b, s, n)),
                             dtype=torch.float32, device=dev)
    return (win, M0, ssm.generators, ph, templ), j0


def _bound_ms(torch, args, am, esm, kind="linear", blur=0):
    """Least time of one launch on the card: the bytes it must move (each
    input read once: the window pixels its points' taps cover (2x2
    linear, 4x4 cubic, 2r more per axis with blur r + 1) in each of its C
    channels, the warps, points, template and J0; each output written
    once) over the HBM rate, against its FLOPs over the float32 rate.
    Returns (ms, "bytes" | "operations", bytes, flops)."""
    win, M0, gens, ph, templ = args
    b, hc, wc = win.shape[0], win.shape[-2], win.shape[-1]
    c = win.shape[1] if win.dim() == 4 else 1
    n = ph.shape[-1]
    s = gens.shape[0]
    r = blur - 1 if blur > 1 else 0
    q = M0 @ ph
    lo, hi, taps, first = ((0.001, 1.001, 2, 0) if kind == "linear"
                           else (1.001, 2.001, 4, -1))
    taps, first = taps + 2 * r, first - r
    x = torch.clamp(q[:, 0] / q[:, 2], lo + r, wc - hi - r).floor().long() \
        + first
    y = torch.clamp(q[:, 1] / q[:, 2], lo + r, hc - hi - r).floor().long() \
        + first
    i0 = y * wc + x
    idx = torch.cat([i0 + (rr * wc + j) for rr in range(taps)
                     for j in range(taps)], dim=-1)
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    cover.scatter_(1, idx, True)
    n_out = s + s * s + ((2 * s + 5) if am == "ncc" else 0)
    nbytes = 4 * (c * int(cover.sum()) + b * (9 + 3 * n + c * n)
                  + gens.numel() + (b * s * n if esm else 0) + b * c * n
                  + b * n_out)
    # per point: projection and reciprocal ~20, warp Jacobian 24 per state
    # dim, tap weights (linear ~8, cubic 8 taps of ~14; blurred: each of
    # the 2 x taps weights summed over 2r + 1 taps of ~6 / ~14), ESM mean
    # 2 per dim; per channel: the value and derivatives from the taps
    # (linear ~20, cubic 16 taps x 2 sums x 2 + 24; blurred taps^2 x 4 +
    # 6 taps), Jm 3 per dim, the residual, 2 per accumulator
    n_acc = s + s * (s + 1) // 2 + ((2 * s + 5) if am == "ncc" else 0)
    if r:
        weights = 2 * taps * (2 * r + 1) * (6 if kind == "linear" else 14)
        sample = 4 * taps * taps + 6 * taps
    else:
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


def _label(am, esm, mc, kind, blur=0):
    """The kernel's name in PERF.md's table: K1-K4 by mode, K1c for the
    cubic taps (a mode of every one of them), K4b for the blurred taps."""
    base = MODES[(am, esm, mc)]
    if blur > 1:
        return f"{base}+K4b"
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


def chain_sum_scales(torch, tk, args, am="ssd", j0=None, kind="linear",
                     blur=0):
    """The rounding scale of each raw chain sum, per tracker: its terms in
    absolute value, summed over points, as `lk_fused_chain_ref` forms them
    (|Jm| through |dx| + |val| and |dy| + |val|: a derivative is a
    difference of pixels and rounds on their scale; |templ| + |val| for
    SSD's residual). Returns the list of (B, ...) tensors in the order of
    the raw sums."""
    window, M0, gens, ph, templ = args
    mc = window.dim() == 4
    win = window if mc else window[:, None]
    xr, yr, jx, jy = tk.project_points(M0, gens, ph)
    val, dx, dy = tk._sample_dense(win, xr, yr, kind, blur)
    v = val.abs()
    jm = (jx.abs()[:, None] * (dx.abs() + v)[:, :, None]
          + jy.abs()[:, None] * (dy.abs() + v)[:, :, None])  # (B, C, S, N)
    t = templ.abs()
    if mc:
        return [(jm * (t + v)[:, :, None]).sum((1, 3)),
                (jm @ jm.transpose(-1, -2)).sum(1)]
    v, jm = v[:, 0], jm[:, 0]
    if j0 is not None:
        jm = 0.5 * (jm + j0.abs())
    if am == "ncc":
        return list(tk.ncc_moments(v, t, jm))
    return [(jm * (t + v)[:, None]).sum(-1), jm @ jm.transpose(1, 2)]


def gn_sum_scales(torch, tk, args, kind="linear", crop=None):
    """`chain_sum_scales` of K6's g and JtJ (`lk_fused_gn_t_ref`'s terms
    in absolute value, in each tracker's `gn_crop` window)."""
    window, pts, jac, templ = args
    b, h, w = window.shape
    origin, hc, wc = tk.gn_crop(pts, h, w, crop)
    oi = origin.long()
    rows = oi[:, 1, None] + torch.arange(hc, device=window.device)
    cols = oi[:, 0, None] + torch.arange(wc, device=window.device)
    sub = window[torch.arange(b, device=window.device)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]
    xy = pts - origin[:, :, None]
    val, dx, dy = tk._sample_dense(sub[:, None], xy[:, 0], xy[:, 1], kind)
    v, s = val[:, 0].abs(), jac.shape[1] // 2
    jm = (jac[:, :s].abs() * (dx.abs() + v[:, None])
          + jac[:, s:].abs() * (dy.abs() + v[:, None]))         # (B, S, N)
    return [(jm * (templ.abs() + v)[:, None]).sum(-1),
            jm @ jm.transpose(1, 2)]


def raw_verdict(torch, gots, wants, scales=None):
    """RAW_REL's rule over B trackers' raw sums (lists of (B, ...)
    tensors): a tracker passes when each of its sums is within RAW_REL of
    its norm of the float32 plain form `wants`. Given the sums' rounding
    scales (`chain_sum_scales`, `gn_sum_scales`; S != 8 only), a sum also
    passes within RAW_REL of its norm plus ROUND_K float32 epsilons of
    its scale. Returns {ok, err_raw (the largest error over trackers, as a
    share of the norm), passed (per tracker)} and, given `scales`,
    {by_floor (the trackers only the floor passed), factor (the largest
    number of epsilons of the scale that a sum beyond RAW_REL needed)}."""
    passed = torch.ones(gots[0].shape[0], dtype=torch.bool,
                        device=gots[0].device)
    near_all = passed.clone()
    err, factor = 0.0, 0.0
    for i, (a, w) in enumerate(zip(gots, wants)):
        dims = tuple(range(1, a.dim()))
        d = (a - w).abs().amax(dims)
        nrm = torch.linalg.vector_norm(w, dim=dims)
        err = max(err, float((d / nrm).max()))
        near = d <= RAW_REL * nrm
        near_all &= near
        ok = near
        if scales is not None:
            unit = EPS32 * scales[i].abs().amax(dims)
            need = (d - RAW_REL * nrm) / unit
            ok = near | (need <= ROUND_K)
            if bool((~near).any()):
                factor = max(factor, float(need[~near].max()))
        passed &= ok
    out = dict(ok=bool(passed.all()), err_raw=err, passed=passed)
    if scales is not None:
        out.update(by_floor=passed & ~near_all, factor=factor)
    return out


def _planted_faults(torch, run, want, scales, verdict, faulty_args):
    """`raw_verdict` (with the floor, `scales` of the sound inputs) on the
    kernel's sums of each planted fault: `faulty_args` [(name, args)] run
    through `run`, held against the sound inputs' plain form `want`.
    `verdict` is the sound run's. Returns {name: {rejected,
    trackers_rejected, floor_trackers (those only the floor passed in the
    sound run), floor_trackers_rejected}}."""
    out = {}
    by = verdict["by_floor"]
    for name, args in faulty_args:
        got = run(*args)
        v = raw_verdict(torch, got[1:], want[1:], scales)
        rej = ~v["passed"]
        out[name] = dict(rejected=not v["ok"],
                         trackers_rejected=int(rej.sum()),
                         floor_trackers=int(by.sum()),
                         floor_trackers_rejected=int((rej & by).sum()))
    return out


def _sums_verdict(torch, run, args, got, want, scales_of, s, rows):
    """The raw sums `got` of `run(*args)` against the plain form's `want`
    by `raw_verdict`. At S != 8, where they miss, again with the rounding
    floor (`scales_of()`); where the floor passes them, with
    PLANTED_FAULTS: the window (args[0]) rounded to bfloat16, and args[2]
    (the generators, or K6's Jacobian) with `rows` scaled by 1 + 1e-3.
    Returns (verdict, the planted faults' results or None)."""
    v = raw_verdict(torch, got[1:], want[1:])
    if v["ok"] or s == 8:
        return v, None
    scales = scales_of()
    v = raw_verdict(torch, got[1:], want[1:], scales)
    if not v["ok"]:
        return v, None
    third = args[2].clone()
    third[rows] *= 1 + 1e-3
    return v, _planted_faults(torch, run, want, scales, v, [
        (PLANTED_FAULTS[0], (args[0].bfloat16().float(),) + tuple(args[1:])),
        (PLANTED_FAULTS[1], tuple(args[:2]) + (third,) + tuple(args[3:]))])


def _floor_fields(row, v, planted):
    """Record the rounding floor's readings on a kernel-phase row."""
    if "factor" in v:
        row.update(n_by_floor=int(v["by_floor"].sum()),
                   floor_factor=v["factor"])
    if planted is not None:
        row["planted"] = planted


def _floor_note(row):
    if "floor_factor" not in row:
        return ""
    note = (f" ({row['n_by_floor']} trackers by the rounding floor, at "
            f"most {row['floor_factor']:.3g} epsilons of the scale")
    if "planted" in row:
        note += "; planted faults: " + ", ".join(
            f"{k} rejected on {r['trackers_rejected']} trackers, "
            f"{r['floor_trackers_rejected']} of the floor's "
            f"{r['floor_trackers']}" for k, r in row["planted"].items())
    return note + ")"


def _chain_row(torch, tk, args, j0, am, esm, kind, blur, name, card, reps,
               plain_reps, **meta):
    """One chain-kernel launch against its plain form on the card (val
    within 1e-3; raw sums by `raw_verdict`, its rounding floor at S != 8
    only, with the planted faults wherever it was needed; NCC's combined
    g and H within NCC_COMBINED_REL), both timed by CUDA events, with the
    launch's bound. Returns the row."""
    s = args[2].shape[0]

    def run(*a):
        return tk.lk_fused_chain_raw(*a, am=am, j0=j0, kind=kind, blur=blur)

    got = run(*args)
    torch.cuda.synchronize()
    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind, blur=blur)
    err_v = float((got[0] - want[0]).abs().max())
    v, planted = _sums_verdict(
        torch, run, args, got, want, lambda: chain_sum_scales(
            torch, tk, args, am, j0, kind, blur), s, 0)
    row = dict(meta, s=s, blur=blur, err_v=err_v, err_raw=v["err_raw"])
    _floor_fields(row, v, planted)
    _check(np.isfinite(err_v) and np.isfinite(v["err_raw"]),
           f"{name}: non-finite output")
    _check(err_v <= 1e-3 and v["ok"],
           f"{name}: cuda vs plain val {err_v}, raw sums {v['err_raw']} of "
           f"norm{_floor_note(row)}")
    for fault, r in (planted or {}).items():
        _check(r["rejected"], f"{name}: the planted fault '{fault}' passed "
               f"the raw-sum rule ({r})")
    if am == "ncc":
        gk, hk = tk.ncc_combine(*got[1:])
        gp, hp = tk.ncc_combine(*want[1:])
        row["err_g"] = _rel_err(torch, gk, gp)
        row["err_h"] = _rel_err(torch, hk, hp)
        _check(row["err_g"] <= NCC_COMBINED_REL
               and row["err_h"] <= NCC_COMBINED_REL,
               f"{name}: combined g {row['err_g']} H {row['err_h']} of norm")
    del got, want
    row["ms"] = _time_ms(torch, lambda: run(*args), reps)
    row["plain_ms"] = _time_ms(torch, lambda: tk.lk_fused_chain_ref(
        *args, am=am, j0=j0, kind=kind, blur=blur), plain_reps)
    (row["bound_ms"], row["bound_by"], row["bytes"],
     row["flops"]) = _bound_ms(torch, args, am, esm, kind, blur)
    extra = ("" if am != "ncc" else
             f", combined g {row['err_g']:.3g} H {row['err_h']:.3g}")
    print(f"{name}{f' blur={blur}' if blur > 1 else ''}: max|dval| "
          f"{err_v:.3g}, raw sums {row['err_raw']:.3g} of norm"
          f"{_floor_note(row)}{extra}; cuda {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {row['bytes'] / 1e6:.1f} MB, "
          f"{row['flops'] / 1e9:.2f} GFLOP) ({card})")
    return row


def _kernel_phase(torch, tk, frames, card, dev, s=8, blur=0, specs=None,
                  n_points=N_POINTS, reps=50, plain_reps=5):
    """Every instantiation of state size `s` (with `blur`'s taps) against
    its plain form and timed (`_chain_row`), at each N; `frames` maps a
    channel count to the scene with that many channels. Returns {(mode,
    n, C): row}."""
    rows = {}
    for am, esm, c, kind, b in specs or _kernel_specs():
        label = _label(am, esm, c > 1, kind, blur)
        mode = tk.mode_name(am, esm, c > 1, kind, s, blur > 1)
        for n in n_points:
            args, j0 = _chain_inputs(torch, frames[c], n, b, am, esm, dev,
                                     ssm_key=SSM_OF_S[s])
            rows[(mode, n, c)] = _chain_row(
                torch, tk, args, j0, am, esm, kind, blur,
                f"{label} {mode} C={c} N={n} B={b}", card, reps, plain_reps,
                b=b, c=c)
            del args, j0
            torch.cuda.empty_cache()
    return rows


def _subgrid_phase(torch, tk, frame_d, card, dev):
    """ssd:s2 at the sub-tracker grid's shapes: B_RKLT x 100 sub-trackers,
    N = 16 (its stride-2 phase) and 64 (8x8 templates), 32-px windows,
    `_chain_inputs` operands (random templates: on the fleet's own
    operands the full-resolution call's g is float32 noise on converged
    sub-trackers, see PERF.md), against its plain form (`_chain_row`).
    Returns {N: row}."""
    rows, b = {}, B_RKLT * 100
    for n in (16, 64):
        args, j0 = _chain_inputs(torch, frame_d, n, b, "ssd", False, dev,
                                 ssm_key="2", size=SUBGRID_CROP,
                                 span=SUBGRID_CROP)
        rows[n] = _chain_row(
            torch, tk, args, j0, "ssd", False, "linear", 0,
            f"K1 sub-grid {tk.mode_name('ssd', False, False, 'linear', 2)} "
            f"N={n} B={b} window {SUBGRID_CROP}", card, 50, 5, b=b, c=1)
        del args, j0
        torch.cuda.empty_cache()
    return rows


def _gn_operands(torch, frame, n, b, s, dev, pad=16):
    """K6 operands at the fleets' shapes: the chain kernel's (`_chain_inputs`
    of the s-DOF SSM) on windows `pad` px wider on every side, the points
    projected (window px) and the warp Jacobian (2S, N) formed as the
    chain kernel forms them (`project_points`). Returns (window, pts, jac,
    templ)."""
    (win, M0, gens, ph, templ), _ = _chain_inputs(
        torch, frame, n, b, "ssd", False, dev, ssm_key=SSM_OF_S[s],
        size=CROP + 2 * pad)
    from mtf_tpu_torch.ops.kernels.lk_fused import project_points
    M0 = M0.clone()
    M0[:, :2] += pad * M0[:, 2:3]
    xr, yr, jx, jy = project_points(M0, gens, ph)
    return (win, torch.stack([xr, yr], 1).contiguous(),
            torch.cat([jx, jy], 1).contiguous(), templ)


def _gn_bound(torch, tk, win, pts, jac, kind, crop):
    """Least time of one K6 launch: the bytes it must move (the window
    pixels its taps cover, 8 B of points, 8S B of Jacobian, 4 B of
    template and 4 B of val per point, g and JtJ) over the HBM rate,
    against ~40 (linear) or ~150 (cubic) FLOPs per point for the taps and
    samples, 3 per state dim for Jm and 2 per accumulator, over the
    float32 rate. Returns (ms, "bytes" | "operations", bytes, flops)."""
    b, h, w = win.shape
    n = pts.shape[-1]
    s = jac.shape[1] // 2
    origin, hc, wc = tk.gn_crop(pts, h, w, crop)
    lo, hi, taps, first = ((0.001, 1.001, 2, 0) if kind == "linear"
                           else (1.001, 2.001, 4, -1))
    xy = pts - origin[:, :, None]
    x = torch.clamp(xy[:, 0], lo, wc - hi).floor().long() + first \
        + origin[:, 0, None].long()
    y = torch.clamp(xy[:, 1], lo, hc - hi).floor().long() + first \
        + origin[:, 1, None].long()
    i0 = y * w + x
    cover = torch.zeros((b, h * w), dtype=torch.bool, device=win.device)
    cover.scatter_(1, torch.cat([i0 + (r * w + j) for r in range(taps)
                                 for j in range(taps)], dim=-1), True)
    nbytes = 4 * int(cover.sum()) + b * n * (8 + 8 * s + 8) \
        + 4 * b * (s + s * s)
    flops = b * n * ((40 if kind == "linear" else 150) + 3 * s
                     + s * (s + 3))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _gn_phase(torch, tk, frame_d, card, dev):
    """K6 at every S and kind, with and without the crop, against its
    plain form on the card (val within 1e-3, g and JtJ within RAW_REL of
    their norms), timed by CUDA events, with its bound. Returns {(S, kind,
    crop): row}."""
    rows = {}
    for s in STATE_DIMS:
        args = _gn_operands(torch, frame_d, N_POINTS[-1], B, s, dev)
        for kind in KINDS:
            for crop in (None, CROP):
                def run(*a):
                    return tk.lk_fused_gn_t(*a, kind=kind, crop=crop)

                got = run(*args)
                torch.cuda.synchronize()
                want = tk.lk_fused_gn_t_ref(*args, kind=kind, crop=crop)
                err_v = float((got[0] - want[0]).abs().max())
                v, planted = _sums_verdict(
                    torch, run, args, got, want,
                    lambda: gn_sum_scales(torch, tk, args, kind, crop), s,
                    (slice(None), [0, s]))
                name = f"K6 {tk.gn_mode_name(s, kind)} crop={crop}"
                row = dict(s=s, kind=kind, crop=crop, err_v=err_v,
                           err_raw=v["err_raw"])
                _floor_fields(row, v, planted)
                _check(np.isfinite(err_v) and err_v <= 1e-3 and v["ok"],
                       f"{name}: cuda vs plain val {err_v}, g / JtJ "
                       f"{v['err_raw']} of norm{_floor_note(row)}")
                for fault, r in (planted or {}).items():
                    _check(r["rejected"], f"{name}: the planted fault "
                           f"'{fault}' passed the raw-sum rule ({r})")
                del got, want
                row["ms"] = _time_ms(torch, lambda: run(*args), 20)
                row["plain_ms"] = _time_ms(torch, lambda: tk.lk_fused_gn_t_ref(
                    *args, kind=kind, crop=crop), 3)
                (row["bound_ms"], row["bound_by"], row["bytes"],
                 row["flops"]) = _gn_bound(torch, tk, args[0], args[1],
                                           args[2], kind, crop)
                rows[(s, kind, crop)] = row
                print(f"{name} B={B} N={N_POINTS[-1]} window "
                      f"{args[0].shape[-1]}: max|dval| {err_v:.3g}, g / JtJ "
                      f"{row['err_raw']:.3g} of norm{_floor_note(row)}; "
                      f"cuda {row['ms']:.4f} ms, "
                      f"plain {row['plain_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                      f"{row['bytes'] / 1e6:.1f} MB) ({card})")
        del args
        torch.cuda.empty_cache()
    return rows


def oracle_operands(torch, n, key, dev, seed=3):
    """The K1-vs-K6 oracle's operands (a port of
    `tests/test_dense_interp.py:134-181`), on `dev`: a random (128, 128)
    image, a random near-identity state of SSM `key` under a 60-px
    normalisation, a side x side grid plus random base points (3, n), a
    random template, and the (2S, n) warp Jacobian of the point map at
    that state by forward mode (`torch.func.jvp`). Returns (img, M0, gens,
    ph, templ, pts (2, n), jac (2S, n))."""
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    img = torch.tensor(rng.uniform(0, 255, (128, 128)), dtype=torch.float32,
                       device=dev)
    ssm = get_ssm(key, device=dev)
    s = ssm.dof
    state = torch.tensor(rng.normal(0, 0.02, s), dtype=torch.float32,
                         device=dev)
    side = int(np.sqrt(n))
    lin = np.linspace(-0.5, 0.5, side)
    g = np.stack(np.meshgrid(lin, lin), -1).reshape(-1, 2)
    g = np.concatenate([g, rng.uniform(-0.5, 0.5, (n - side * side, 2))])
    ph = torch.tensor(np.concatenate([g.T, np.ones((1, n))]),
                      dtype=torch.float32, device=dev).contiguous()
    norm = torch.tensor([[60.0, 0, 64], [0, 60.0, 64], [0, 0, 1]],
                        device=dev)
    M0 = norm @ ssm.to_matrix(state)
    templ = torch.tensor(rng.uniform(0, 255, n), dtype=torch.float32,
                         device=dev)

    def pts_of(dp):
        q = (M0 @ ssm.to_matrix(dp)) @ ph
        return q[:2] / q[2:3]

    zero = torch.zeros(s, device=dev)
    eye = torch.eye(s, device=dev)
    rows = [torch.func.jvp(pts_of, (zero,), (eye[i],))[1] for i in range(s)]
    jac = torch.cat([torch.stack([r[0] for r in rows]),
                     torch.stack([r[1] for r in rows])])
    return (img, M0.contiguous(), ssm.generators, ph, templ,
            pts_of(zero).contiguous(), jac.contiguous())


def _oracle_phase(torch, tk, dev):
    """The K1-vs-K6 oracle on the card: the chain kernel (CUDA) against K6
    (CUDA) fed the warp Jacobian built by forward mode (`oracle_operands`),
    S in ORACLE_KEYS, N = 1024 and 4500: val within 1.0, g and JtJ within
    1e-4 of their norms (the reference's tolerances). Returns {(key, n):
    errors}."""
    out = {}
    for key in ORACLE_KEYS:
        for n in (1024, 4500):
            img, M0, gens, ph, templ, pts, jac = oracle_operands(torch, n,
                                                                 key, dev)
            v1, g1, h1 = tk.lk_fused_gn_t(img[None], pts[None], jac[None],
                                          templ[None])
            v2, g2, h2 = tk.lk_fused_chain(img[None], M0[None], gens,
                                           ph[None], templ[None])
            torch.cuda.synchronize()
            e = dict(val=float((v1 - v2).abs().max()),
                     g=float((g1 - g2).abs().max() / g1.norm()),
                     h=float((h1 - h2).abs().max() / h1.norm()))
            _check(e["val"] <= 1.0 and e["g"] <= 1e-4 and e["h"] <= 1e-4,
                   f"K1 vs K6 oracle S={gens.shape[0]} N={n}: {e}")
            print(f"K1 vs K6 oracle S={gens.shape[0]} ({key}) N={n}: "
                  f"max|dval| {e['val']:.3g}, g {e['g']:.3g}, JtJ "
                  f"{e['h']:.3g} of norm")
            out[(key, n)] = e
    return out


def _counts(tk, gf):
    """Every kernel's launch count: the chain kernel's per mode and state
    size, K6's per state size and kind, the grid flow's per tap kind as
    `grid_flow@<kind>`."""
    return {**tk.lk_fused_chain_raw.launches, **tk.lk_fused_gn_t.launches,
            **{f"grid_flow@{k}": v for k, v in gf.grid_flow.launches.items()}}


def _zero_counts(tk, gf):
    for counts in (tk.lk_fused_chain_raw.launches, tk.lk_fused_gn_t.launches,
                   gf.grid_flow.launches):
        for k in counts:
            counts[k] = 0


def _fleet(torch, key, am, b, card, corners, frame_d, dev, tk, gf, expect,
           windows=WINDOWS, warmup=WARMUP, interp="linear_mm", cfg=None,
           label=None, ssm="8"):
    """The fleet's main path: `warmup` updates, then `windows` timed
    windows of STEPS updates; the launch counts are zeroed just before
    and read just after, and each kernel must have launched exactly
    `expect[name]` times per update (0 for any name not in `expect`)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    label = label or f"{key}/{am} {interp}"
    sm = create_tracker(key, am, ssm, device=dev,
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
                      interp="linear_mm", cfg=None, ssm="8", boundary=None):
    """The same trackers on the plain path (CPU tensors: the kernels'
    plain forms) agree with the CUDA path, each tracker within
    PLAIN_PATH_TOL_PX; a tracker named in `boundary` {index: why} is held
    to PLAIN_PATH_BOUNDARY_TOL_PX instead. The grid's RANSAC draw comes
    from a generator on each path's device, so each CPU grid is handed its
    CUDA twin's draws. Returns the largest difference of the other
    trackers."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.sm.grid import GridTracker, SubTrackerGrid
    cfg = cfg if cfg is not None else cfg_of(key, interp)
    boundary = boundary or {}
    cpu_sm = create_tracker(key, am, ssm, device="cpu", **cfg)
    grids = (GridTracker, SubTrackerGrid)
    cuda_grids = [m for m in sm.modules() if isinstance(m, grids)]
    cpu_grids = [m for m in cpu_sm.modules() if isinstance(m, grids)]
    for g_cuda, g_cpu in zip(cuda_grids, cpu_grids):
        g_cpu._hyp_indices = (lambda draw: lambda step, n: draw(step, n).cpu()
                              )(g_cuda._hyp_indices)
    sub = corners[:PLAIN_PATH_TRACKERS]
    st_g = sm.initialize(frames[0], sub)
    st_c = cpu_sm.initialize(frames[0].cpu(), sub)
    per = np.zeros(len(sub))
    for t in range(1, 3):
        st_g = sm.update(st_g, frames[t])
        st_c = cpu_sm.update(st_c, frames[t].cpu())
        d = (sm.corners(st_g).cpu() - cpu_sm.corners(st_c)).abs()
        per = np.maximum(per, d.flatten(1).amax(1).numpy())
    named = np.isin(np.arange(len(sub)), list(boundary))
    diff = float(per[~named].max())
    _check(diff < PLAIN_PATH_TOL_PX,
           f"{label}: CUDA path vs plain path corners differ by {diff} px "
           f"(per tracker {per.tolist()})")
    for i, why in boundary.items():
        _check(per[i] < PLAIN_PATH_BOUNDARY_TOL_PX,
               f"{label}: tracker {i} ({why}) differs by {per[i]} px")
    print(f"{label} plain-path check: {PLAIN_PATH_TRACKERS} trackers, 2 "
          f"frames, max corner diff {diff:.3g} px, per tracker "
          f"{[float(f'{x:.3g}') for x in per]}"
          + "".join(f"; tracker {i} ({why}) {per[i]:.3g} px (limit "
                    f"{PLAIN_PATH_BOUNDARY_TOL_PX})"
                    for i, why in boundary.items()))
    return diff


def _ptxas_k5(log):
    """{(points per lane K, tap kind): (registers, spill store bytes, spill
    load bytes)} of the grid-flow kernel's instantiations (mangled
    ILi<K>ELi<kind>E)."""
    usage = {}
    for name, *use in _ptxas(log, "grid_flow_kernel"):
        k, kind = re.search(r"ILi(\d+)ELi(\d)E", name).groups()
        usage[(int(k), KINDS[int(kind)])] = tuple(use)
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


_ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "err_v", "err_raw",
             "n_by_floor", "floor_factor", "planted", "err_g", "err_h",
             "b", "c")


def _sub(row):
    return {k: row[k] for k in _ROW_KEYS if k in row}


def _chain_s_entry(tk, rows_s, s, launches, usage):
    """The kernels-line entry of the chain kernel at state size `s`: its
    SSD linear-tap row as the headline (B = 1280, N = 2500), every other
    instantiation under `by_mode`; `launches` {mode: count} of the slice-6
    main paths (the fleets and the other SSM keys' entry points)."""
    head = rows_s[(tk.mode_name("ssd", False, False, "linear", s),
                   N_POINTS[-1], 1)]
    regs = {tk.mode_name(am, esm, mc, kind, s): usage[(s, am, esm, mc, kind,
                                                       False)]
            for am, esm, mc, kind in tk.INSTANTIATIONS}
    return {
        "name": f"lk_fused_chain:s{s} (K1-K4, K1c at S = {s})",
        "route": "cuda", "source": SOURCE,
        "replaces": f"{REPLACES} (n_s = gens.shape[0], :519)",
        "launches": sum(launches.values()), "launches_by_mode": launches,
        "max_abs_err": max(r["err_v"] for r in rows_s.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"ssd: B={B}, window {CROP}x{CROP}, N=2500, linear taps, "
                 f"S={s}; by_mode: each mode at its fleet's B (ssd_mc C=3)",
        "registers": {k: v[0] for k, v in regs.items()},
        "spill_stores": max(v[1] for v in regs.values()),
        "spill_loads": max(v[2] for v in regs.values()),
        "by_mode": {m: _sub(r) for (m, _, _), r in rows_s.items()},
    }


def _k4b_entry(tk, rows_b, launches, usage):
    """The kernels-line entry of the blurred taps (K4b): S = 8 SSD linear
    at blur 2 (N = 625, B = 1280) as the headline, every (S, blur, mode)
    under `by_case`; `launches` are the kernel phase's (no tracker path
    blurs taps)."""
    head = rows_b[(8, 2)][(tk.mode_name("ssd", False, False, "linear", 8,
                                        True), 625, 1)]
    regs = {tk.mode_name(am, esm, mc, kind, st, True):
            usage[(st, am, esm, mc, kind, True)]
            for st in STATE_DIMS for am, esm, mc, kind in tk.INSTANTIATIONS}
    return {
        "name": "lk_fused_chain+blur (K4b, blurred taps)",
        "route": "cuda", "source": SOURCE, "replaces": K4B_REPLACES,
        "launches": sum(launches.values()), "launches_by_mode": launches,
        "max_abs_err": max(r["err_v"] for rows in rows_b.values()
                           for r in rows.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"ssd: B={B}, window {CROP}x{CROP}, N=625, linear taps, "
                 "blur 2, S=8; by_case: S 8 and 6, blur 2 and 3 at N=625, "
                 "4 at N=169, every mode and kind",
        "registers": {k: v[0] for k, v in regs.items()},
        "spill_stores": max(v[1] for v in regs.values()),
        "spill_loads": max(v[2] for v in regs.values()),
        "by_case": {f"s{st} blur{bl} {m} N={n}": _sub(r)
                    for (st, bl), rows in rows_b.items()
                    for (m, n, _), r in rows.items()},
    }


def _gn_entry(tk, rows_gn, launches, usage_gn, oracle):
    """The kernels-line entry of K6: S = 8 linear without a crop as the
    headline (B = 1280, N = 2500, 176-px windows), every (S, kind, crop)
    under `by_case`, and the K1-vs-K6 oracle's errors; `launches` are the
    kernel phase's (no tracker path runs K6)."""
    head = rows_gn[(8, "linear", None)]
    return {
        "name": "lk_fused_gn_t (K6)",
        "route": "cuda", "source": GN_SOURCE, "replaces": GN_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["err_v"] for r in rows_gn.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"B={B}, N=2500, {CROP + 32}x{CROP + 32} windows, S=8, "
                 f"linear taps, no crop; by_case: every S and kind, crop "
                 f"None and {CROP}",
        "registers": {tk.gn_mode_name(*k): v[0] for k, v in usage_gn.items()},
        "spill_stores": max(v[1] for v in usage_gn.values()),
        "spill_loads": max(v[2] for v in usage_gn.values()),
        "by_case": {f"{tk.gn_mode_name(st, kind)} crop={crop}": _sub(r)
                    for (st, kind, crop), r in rows_gn.items()},
        "oracle_k1_vs_k6": {f"{key} N={n}": e
                            for (key, n), e in oracle.items()},
    }


def _subgrid_entry(tk, rows_sub, launches, usage):
    """The kernels-line entry of ssd:s2 at the sub-tracker grid's shapes:
    the full-resolution row (N = 64) as the headline, both point counts
    under `by_n`; `launches` are the sub-grid fleet's own (the `ssd:s2`
    entry of `lk_fused_chain:s2` counts the other paths)."""
    head = rows_sub[64]
    regs, sst, sld = usage[(2, "ssd", False, False, "linear", False)]
    return {
        "name": "lk_fused_chain[ssd:s2] sub-grid (K1 at S = 2, the "
                "sub-trackers' shapes)",
        "route": "cuda", "source": SOURCE,
        "replaces": f"{REPLACES} (n_s = gens.shape[0], :519)",
        "launches": launches,
        "max_abs_err": max(r["err_v"] for r in rows_sub.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"B={head['b']} sub-trackers, window {SUBGRID_CROP}x"
                 f"{SUBGRID_CROP}, N=64 (by_n: 16 in the stride-2 phase), "
                 "linear taps, S=2",
        "registers": regs, "spill_stores": sst, "spill_loads": sld,
        "by_n": {str(n): _sub(r) for n, r in sorted(rows_sub.items())},
    }


def _rule_summary(row_sets):
    """RAW_REL's rounding floor over every kernel-phase row: the rows and
    trackers only it passed, the most epsilons of the scale they needed
    (ROUND_K is the limit), and the planted faults: on how many rows each
    was run and rejected, and how many of the floor's trackers it failed."""
    used = [r for rs in row_sets for r in rs.values() if "planted" in r]
    faults = {f: {"rows": sum(f in r["planted"] for r in used),
                  "rows_rejected": sum(r["planted"][f]["rejected"]
                                       for r in used),
                  "floor_trackers": sum(r["planted"][f]["floor_trackers"]
                                        for r in used),
                  "floor_trackers_rejected": sum(
                      r["planted"][f]["floor_trackers_rejected"]
                      for r in used)} for f in PLANTED_FAULTS}
    out = {"round_k": ROUND_K, "rows_by_floor": len(used),
           "trackers_by_floor": sum(r["n_by_floor"] for r in used),
           "max_epsilons_needed": max((r["floor_factor"] for r in used),
                                      default=None),
           "planted_faults": faults}
    print(f"raw-sum rule: the rounding floor passed "
          f"{out['trackers_by_floor']} trackers on {len(used)} rows, "
          f"needing at most {out['max_epsilons_needed']} epsilons of the "
          f"scale (ROUND_K {ROUND_K}); planted faults: " + ", ".join(
              f"{f} rejected on {v['rows_rejected']} of {v['rows']} rows, on "
              f"{v['floor_trackers_rejected']} of the floor's "
              f"{v['floor_trackers']} trackers" for f, v in faults.items()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    from mtf_tpu_torch.ops.kernels import lk_fused as tk
    from mtf_tpu_torch.ssm import get_ssm

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
    specs = [("lk_fused_chain", {"LK_S": st}) for st in STATE_DIMS] \
        + ["lk_fused_gn", "grid_flow"]
    libs = _build.load_all(specs)
    build_s = time.perf_counter() - t0
    print("build: " + ", ".join(f"{k} nvcc {v.seconds:.2f} s"
                                for k, v in libs.items())
          + f" (side by side, {build_s:.2f} s in all)")
    usage, spilled = {}, []
    for st in STATE_DIMS:
        got = _ptxas_usage(libs[_build.lib_key("lk_fused_chain",
                                               {"LK_S": st})].log)
        for am, esm, mc, kind in tk.INSTANTIATIONS:
            for blurred in (False, True):
                key = (am, esm, mc, kind, blurred)
                mode = tk.mode_name(am, esm, mc, kind, st, blurred)
                _check(key in got, f"ptxas reported no {mode} instantiation")
                regs, sst, sld = got[key]
                usage[(st,) + key] = got[key]
                label = _label(am, esm, mc, kind, 2 if blurred else 0)
                print(f"ptxas: {label} {mode}: {regs} registers, spill "
                      f"stores {sst} B, spill loads {sld} B")
                if sst or sld:
                    spilled.append(mode)
                if st == 8 and not blurred:
                    want = REGS_S8[(am, esm, mc)][KINDS.index(kind)]
                    _check(regs == want, f"{mode}: {regs} registers, "
                           f"{want} expected (REGS_S8)")
    _check(not spilled, f"chain kernel instantiations spill: {spilled}")
    usage_gn = _ptxas_gn(libs["lk_fused_gn"].log)
    _check(sorted(usage_gn) == sorted(tk.GN_INSTANTIATIONS),
           f"ptxas reported K6 instantiations {sorted(usage_gn)}")
    for (st, kind), (regs, sst, sld) in sorted(usage_gn.items()):
        print(f"ptxas: K6 {tk.gn_mode_name(st, kind)}: {regs} registers, "
              f"spill stores {sst} B, spill loads {sld} B")
        _check(sst == 0 and sld == 0, f"K6 {tk.gn_mode_name(st, kind)} "
               f"spills")
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
    # slice 6: every instantiation at the other state sizes, at N = 2500
    rows_s = {st: _kernel_phase(torch, tk, frames, card, dev, s=st,
                                specs=[sp for sp in _kernel_specs()
                                       if sp[2] in (1, 3)],
                                n_points=N_POINTS[-1:], reps=20,
                                plain_reps=3) for st in NEW_S}
    # K4b: the blurred taps in every mode and kind at S = 8 and 6
    _zero_counts(tk, gf)
    rows_b = {}
    for st in K4B_S:
        for blur, n in K4B_CASES:
            rows_b[(st, blur)] = _kernel_phase(
                torch, tk, frames, card, dev, s=st, blur=blur,
                specs=[sp for sp in _kernel_specs() if sp[2] in (1, 3)],
                n_points=(n,), reps=10, plain_reps=2)
    launches_b = {k: v for k, v in tk.lk_fused_chain_raw.launches.items()
                  if "+blur" in k}
    del frames
    gn0 = dict(tk.lk_fused_gn_t.launches)
    rows_gn = _gn_phase(torch, tk, frame_d, card, dev)
    oracle = _oracle_phase(torch, tk, dev)
    launches_gn = sum(tk.lk_fused_gn_t.launches.values()) - sum(gn0.values())
    corners_rk = _corners(B_RKLT)
    rows_sub = _subgrid_phase(torch, tk, frame_d, card, dev)
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

    # -- slice 6: the matrix SSMs on the chain kernel, the sub-tracker grid --
    ssm_fleets = {}
    launches_s = {st: {} for st in STATE_DIMS}
    for name, (key, am, ssm, b, cfg, expect, timed) in ssm_family().items():
        crn = {B: corners, B_SLICE2: corners2, B_RKLT: corners_rk}[b]
        label = f"{name} ({key}/{am}/{ssm})"
        sm, fps, got = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                              gf, expect, windows=WINDOWS if timed else 0,
                              cfg=cfg, label=label, ssm=ssm)
        for k, v in got.items():
            if ":s" in k and name != "subgrid":
                st = int(k.split(":s")[1][0])
                launches_s[st][k] = launches_s[st].get(k, 0) + v
        reading = SSM_FAMILY_GT_READING_PX[name]
        gt, frames = _gt_leg(sm, frame0, crn, gt_limit(reading), label)
        plain = _plain_path_check(sm, key, am, frames, crn, label, cfg=cfg,
                                  ssm=ssm,
                                  boundary=PLAIN_PATH_BOUNDARY.get(name))
        ssm_fleets[name] = {"B": b, "fps": fps, "gt_px": gt,
                            "gt_limit_px": gt_limit(reading),
                            "jax_cpu_reading_px": reading,
                            "plain_path_px": plain, "launches": got}
        del sm, frames
        torch.cuda.empty_cache()
    for key in OTHER_SSM_KEYS:
        dof = get_ssm(key, device=dev).dof
        mode = tk.mode_name("ssd", False, False, "linear", dof)
        _, _, got = _fleet(torch, "fclk", "ssd", B, card, corners, frame_d,
                           dev, tk, gf, {mode: MAX_ITERS}, windows=0,
                           label=f"fclk/ssd/{key}", ssm=key)
        if dof != 8:
            launches_s[dof][mode] = launches_s[dof].get(mode, 0) + got[mode]
        ssm_fleets[f"fclk_ssd_{key}"] = {"B": B, "launches": got}
    torch.cuda.empty_cache()

    kernels = []
    for am, esm, mc, kind in tk.INSTANTIATIONS:
        label = _label(am, esm, mc, kind)
        mode = tk.mode_name(am, esm, mc, kind)
        c = 3 if mc else 1
        row = rows[(mode, N_POINTS[-1], c)]
        regs, st, ld = usage[(8, am, esm, mc, kind, False)]
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
    for st in NEW_S:
        kernels.append(_chain_s_entry(tk, rows_s[st], st, launches_s[st],
                                      usage))
    kernels.append(_subgrid_entry(tk, rows_sub, ssm_fleets["subgrid"]
                                  ["launches"]["ssd:s2"], usage))
    kernels.append(_k4b_entry(tk, rows_b, launches_b, usage))
    kernels.append(_gn_entry(tk, rows_gn, launches_gn, usage_gn, oracle))
    for kind in KINDS:
        kernels.append(_k5_entry(rows_k5[kind], kind, k5_launches[kind],
                                 usage_k5,
                                 row_k5_mf if kind == "linear" else None))
    rule = _rule_summary([rows, rows_sub, rows_gn] + list(rows_s.values())
                         + list(rows_b.values()))
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
                   **family, **ssm_fleets},
        "raw_sum_rule": rule,
        "build_s": {k: v.seconds for k, v in libs.items()},
        "wall_s": time.perf_counter() - t_start,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
