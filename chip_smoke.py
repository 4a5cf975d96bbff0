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
(`lk_fused_gn_t`), and of slice 8: the generic LK path (no chain kernel)
and every other LK key and option on the path the JAX package's
`_fused_ok` names, and of slice 9: the particle filter and nearest-
neighbour search (the pf500 and nn1k rows) with SSIM, MI and the other
histogram AMs, and of slice 10: the hierarchical ESM, the linear
predictor, the line tracker, RegNet, the SCV family and the illumination
models, and of slice 12: the correlation filters, the learning trackers,
DFT and TLD, and of slice 13: the user entry points (run_mtf, its fleet
mode, the APIs, checkpoints, profiling, eval_suite), and of slice 14: the
cv2 trackers (feat, CMT, the adapters), diagnostics, the frame bridge and
tracker node, parity_cv2, the other apps and the examples, and of slice
15: per-tracker frames (`update_multi`) for PF, NN, LP, RegNet, the
sub-tracker grid, DFT and pfrk, and the options `interp_bf16` (the
kernels' bfloat16-operand flag), `crop_blocks`, `border="constant"` and
`interp_precision`, and of slice 16: the sub-tracker grid without a crop
(its sub-trackers on the whole frame, shared, or their parents' frames by
index):

  1. prints the card's name and power limit (nvidia-smi), and whether
     `cv2` imports on the machine (slice 7's cv2 trackers);
  2. builds the kernel libraries from `mtf_tpu_torch/csrc/`, one nvcc per
     library, side by side: the chain kernel once per state size S in
     STATE_DIMS (30 instantiations each: K1 ssd, K2 ncc, K3 ssd_esm and
     ncc_esm, K4 ssd_mc, each with linear taps and, as K1c, with cubic
     and cubic_bspl taps, each with plain and, as K4b, blurred taps), K6
     (18: 6 state sizes x 3 tap kinds) and the grid-flow kernel (18: 6
     points-per-lane counts, each as K5 with linear taps and K5c with
     cubic and cubic_bspl taps; each launch at the lanes per patch and
     points per lane of `grid_flow.layout`); prints the build times and each
     instantiation's registers and spills (none allowed anywhere; the
     S = 8 plain-tap instantiations must keep REGS_S8);
  3. kernel phase: at the fleets' shapes (ssd B = 1280, the other single-
     channel modes B = 1024, ssd_mc B = 512 with C = 3 and also C = 2 and
     4; N = 169, 625, 2500; every mode with each tap kind) compares each
     CUDA kernel with its plain PyTorch form on the card (val within 1e-3,
     every raw sum within 1e-4 of its norm; NCC's combined g and H within
     1e-3 of their norms, see NCC_COMBINED_REL) and times the kernel by
     CUDA-graph replays (`_graph_ms`: device time, the wrapper's host time
     left out) and the plain form by CUDA events; computes each launch's
     bound from its inputs (the bytes it must move over 3.35 TB/s, its
     FLOPs over 67 TFLOP/s float32);
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
     every one within 1e-2: see K5_TOL), both timed as in 3, and
     each level's bound (the window pixels the taps cover, 12 B per
     point, the disp written, over 3.35 TB/s, against
     K5_FLOPS_PER_PT_ITER per point per iteration over 67 TFLOP/s); then
     K5 at Median Flow's shapes the same way: the six calls of one update
     of the mf fleet (B = 384, P = 100, n = 64, 20 iterations on each of
     3 levels with 56, 96 and 160-px windows, forward and back), where a
     component beyond 1e-2 also passes if the kernel is no further from
     the float64 plain form than the float32 one is, plus 1e-2 (see
     K5_MAX; each such component is printed by tracker, patch and
     component, `scripts/port_mf_parting.py` adds its condition and the
     tracker's fate), reported as the `mf` row of the K5 entry's
     `by_level`;
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
     sub-trackers, N = 16 and 64, 32-px windows); each timed as in 3
     against its plain form, with its bound;
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
 15. slice 8 (`_generic_phase`): the generic fleets (`generic_family`):
     `__graft_entry__.entry()`'s configuration at the esm_ncc row's width
     (eslm/ncc/8, 50x50, `interp="linear"`, `epsilon=0.01`, no crop,
     B = 1024), the spline50 row (fclk/ssd/spline, 32x32, 5 iterations,
     B = 256, GT against its homography leg) and iclk/ssd on the
     headline's shapes (B = 1280), each timed over GENERIC_WINDOWS
     windows of 20 updates with no kernel launched, with its GT leg
     (limits: GENERIC_GT_READING_PX; iclk_ssd by its median and the
     number of trackers it loses, GENERIC_GT_LOST); entry()'s fleet also
     with the
     iterations one update takes until every tracker is done and the
     teacher-forced plain-path check, then that check with
     PLAIN_PATH_FAULT, which must fail it (rklt/ssd's too, in 9); iclm
     on iclk's shapes with
     its GT leg; entry()'s configuration at its own shapes (16x16 on
     64x80 numpy toy frames) for one update with finite corners; then
     3 updates each of every other key and option (`routing_family`,
     B = 256), each launching exactly the chain-kernel mode the JAX
     package's `_fused_ok` names, or nothing on the generic path.
 16. slice 9 (`_stochastic_phase`): the pf500 row (pffc/ssim/8, 25x25,
     500 particles ranked on the blurred stride-4 downsampled frame, the
     top 64 rescored in a 160-px window, then FCLK-LM on SSIM; B = 128)
     and the nn1k row (nnic/mi/8, 25x25, 1,000 samples searched on raw
     pixels, then ICLK-LM on MI at 32 bins; B = 256) at their
     bench_extra.py configurations: 3 warm-ups and STOCH_WINDOWS windows
     of 20 updates on the scene, no kernel of the port launched; 3
     updates under the profiler (device ms, busy share, launches per
     update; every state tensor on the card); the GT leg at each of
     GT_SEEDS, held by its median and the trackers it loses to the JAX
     package's worst seed on the CPU (STOCH_GT_LOST); then 3 updates of
     every other PF and NN option and key and of SPSS, CCRE, KLD and LKLD
     on FCLK with LM (`stochastic_routing`, B = 16, MI's binned features
     at 8),
     pfrk and nnrk launching K5 2 and ssd_esm 10 times per update,
     pfsl3's FCLK the ncc chain kernel until its done masks stop it.
 17. slice 10 (`_slice10_phase`): the fleets of `slice10_family` on the
     scene, each with its exact launches per update: hesm/ssd/8 (ESM on
     the translation, then the homography: ssd_esm:s2 10 and ssd_esm 10
     per update, B = 1024), lpfc/ssd/8 (the 3-stage linear predictor on
     the translation, then FCLK: ssd 10, B = 1280), line/ssd/8 (the rklt
     row's grid with line snapping: K5 2, B = 384), esm/rscv/8 and
     fclk/ssd/8 with PGB (the generic path, B = 1024) and gtrn (RegNet on
     the similitude, 3,000 samples, hidden 256-128, B = 256): WARMUP
     updates and one timed window of STEPS updates, the init's seconds
     apart (LP's and RegNet's training), one update under the profiler
     for hesm, lpfc and esm/rscv; the GT leg (SLICE10_GT_READING_PX,
     SLICE10_GT_FIRST_FRAME, SLICE10_GT_LOST; lpfc and gtrn at GT_SEEDS on
     their first 32 and 16 trackers, SLICE10_LEARNED_GT); the plain-path
     check of hesm, lpfc (the CPU
     LP handed the card's training draws) and line; then that NGF, LSCV,
     LRSCV and DFM raise under coarse phases, and 3 updates of every other
     slice-10 key and option (`slice10_routing`, B = 16): each new AM and
     its `mc` key on FCLK, the sums, GB and RBF, PF with GB's photometric
     walk, lp, lpic, lpes (ssd_esm 10), hrch with FCLK (ssd:s2 10, ssd
     10), RegNet on the translation, NN on ZNCC's and DFM's features.
 18. slice 12 (`_slice12_phase`): the box trackers of `slice12_family` at
     their JAX defaults on the scene: mosse, kcf and dsst (B = 1024; KCF
     and DSST on fHOG), rct, mil, boost, strk, frg, dft (ESM on the
     descriptor fields, the generic path) and tld (B = 256; its Median
     Flow leg on the mf row's dense taps: K5 6 per update), each with its
     exact launches, WARMUP updates and one timed window of STEPS
     updates, one update under the profiler and the GT leg on the
     homography's sequence (SLICE12_GT_READING_PX; SLICE12_GT_LOST for
     the box trackers, which lose most trackers by LOST_PX in the JAX
     package too); then 3 updates of each CF key with its other features
     and of dft with FCLK on dense taps (`slice12_routing`: K4 on the
     4-channel fields, 1-30 per update), and TLD's occlusion leg
     (`_tld_occlusion`: `tests/test_tld.py`'s scene, box, trajectory and
     occluder at B = 16; every tracker invalid while hidden, the
     re-acquired count held to TLD_OCC_REACQUIRED).
 19. slice 13 (`_slice13_phase`): the user entry points. It records a
     480x640 8-bit PNG sequence of SLICE13_FRAMES frames and its MTF GT
     file (`slice13_sequence`: the port's synth on the card, the scene's
     SLICE13_BOX on the homography's random walk); runs
     `mtf_tpu_torch.apps.run_mtf.main` in-process on it with
     `--write_outputs --reinit_on_failure` for fclk/ssd, esm/ncc and
     rklt/ssd at the bench configuration given as CLI pairs
     (`slice13_legs`), each with its exact launches per update (K1 10,
     K2 + K3 10, K3 10 and K5 2), its avg_mcd within `gt_limit` of the
     JAX package's reading on the CPU and its failures equal to the JAX
     count (SLICE13_JAX_READING), its artifacts read back through the
     port's `utils.gt` and its state on the card; then the fleet mode
     (`--synthetic --n_objs 16` under each protocol and a forced failure
     path, against 16 single-object `run_single` runs on the same frames,
     within SLICE13_FLEET_TOL_PX); pyMTF, pyMTF2 (two trackers; it prints
     which frame reader it took) and a mex round trip against run_mtf's
     fclk/ssd corners (SLICE13_API_TOL_PX); a fleet checkpointed mid-run
     whose resumed update equals the uninterrupted one; a `Profiler`
     section and a `trace` that must hold the chain kernel; and the
     port's `eval_suite` at SLICE13_SUITE_FRAMES frames, which must exit
     0.
 20. slice 14 (`_slice14_phase`), before the parallel phase: feat/ssd/8
     (ORB, SLICE14_FEAT_CFG) and cmt at B_SLICE14 on the 480x640 blob
     scene (`blob_scene`, `slice14_corners`), each on its 6-frame GT leg
     within `gt_limit` of the JAX package's CPU reading
     (SLICE14_JAX_READING, `scripts/port_slice14_reference_leg.py`),
     launching no kernel, and its device stage on one frame's host
     detections and one draw within SLICE14_TOL_PX of the same stage on
     the CPU; the cv2 adapters (`third_party.available()` printed; mil's
     corners equal to the boxes its cv2 object answered; csrt, visp and
     cv3 build and run where cv2 has them, else raise the JAX package's
     NotImplementedError); `diagnose --am ncc --ssm 8 --validate` exits 0
     and `validate_chain` is ok; `apps.tracker_node` in a subprocess on
     the card over the shared-memory bridge at fclk/ssd/8 (the bench
     configuration: K1 10 an update, read from the node's own counts),
     its corners file within SLICE14_NODE_TOL_PX of the tracker run
     in-process; `parity_cv2` at its defaults (its trackers on the
     generic path: no launch), each of its rows within `gt_limit` of the
     JAX reading and parity in both families; `register_seq` and
     `create_mosaic` at esm/ncc/8 (K3 10 an update) on the slice-13
     sequence, their outputs read back; `track_markers` and
     `track_uav_trajectory` (K3 10 an update) against GT;
     `generate_synthetic_seq`, `extract_patch`, `show_ground_truth` and
     `record_seq`; the three demos of `mtf_tpu_torch/examples/`, each
     demo's error within `gt_limit` of the JAX reading. SLICE14_BUDGET_S
     is the phase's aim.
 21. slice 15 (`_slice15_phase`), before the parallel phase: the
     bfloat16-operand flag's libraries (the chain kernel per S, K5/K5c;
     built in 2, each instantiation without spills) against their plain
     forms under the flag at the kernel phase's shapes (every chain mode
     and kind at S = 8, N = 2500, on windows rounded to bfloat16, under
     3's rules; K5/K5c at both rklt levels, held iteration by iteration
     on the plain form's trajectory, `_k5_bf16_check`), each timed beside
     its unflagged row; then per-tracker frames (`update_multi`) on the
     fleets of `slice15_family` at their full widths (pf500 B = 128, nn1k
     B = 256, lpfc B = 1280, gtrn B = 256, the sub-tracker grid B = 384 of
     100 sub-trackers each, dft on FCLK (K4, C = 4) B = 256, pfrk
     B = 128): `update_multi` on B copies of a frame against `update` (bit
     for bit), the per-tracker GT leg (tracker b on sequence b mod 8 of
     SLICE15_SEQ_SEEDS; the draws' fleets at GT_SEEDS; held by
     `slice15_limits` of the JAX reading, SLICE15_JAX_READING,
     `scripts/port_slice15_reference_leg.py`), the sub-tracker grid's
     peak memory over its leg (under its frames' bytes +
     SLICE15_MEM_MARGIN: no frame per sub-tracker), exact launches and one
     timed window of 20 `update_multi` beside 20 `update` calls; the
     option legs of `slice15_options` (fclk/ssd/8 B = 1280 and rklt/ssd/8
     B = 384 with `interp_bf16`: K1 and K3 + K5 with the flag, their GT
     legs and plain-path checks; pf500 with `interp_bf16`; fclk/ssd/8
     B = 1280 with `crop_blocks` (2, 2): the generic path; fclk/ssd/8
     B = 1024 on gather taps with `border="constant"`, every odd tracker a
     quarter across the frame's edge: the inner trackers' GT, the edge
     trackers' corners changed by the border; `interp_precision` highest
     against the default, bit for bit); and 3 updates of every flagged
     mode and kind through the entry points (`slice15_bf16_routing`).
     SLICE15_BUDGET_S is the phase's aim. (Slice 13's eval_suite runs
     SLICE13_SUITE_FRAMES frames, down from 20, to keep the whole script
     under 1,000 s.)
 22. slice 16 (`_slice16_phase`), after slice 15: ssd:s2 against its
     plain form under 3's rules on the whole 480x640 frame shared at a
     batch stride of 0 (B = 38,400 sub-trackers, N = 16 and 64, some
     sub-trackers past the frame's edges: the clamps at frame size;
     `_slice16_kernels`); then the sub-tracker grid of 14 (B = 384 of
     100) with crop 32 and without a crop (`slice16_family`), each with
     its exact launches (ssd:s2 10 per update), timed (3 warm-ups, one
     window of 20 updates), profiled (device ms per update) and its
     peak memory over its updates; the no-crop grid's GT leg (limit from
     SLICE16_GT_READING_PX, `scripts/port_slice16_reference_leg.py`) and
     plain-path check; its `update_multi` on B copies of the frame
     against `update` (bit for bit) and on per-tracker frames (B runs of
     100 sub-trackers: ssd:s2 B x 10 per update, exactly), timed; and
     3 updates of the ICLK sub-trackers' grid (the generic path, no
     kernel launch).
 The plain-path checks (4, 5, 9-11, 13-15, 17, 22) drive an LM tracker's plain
 path with the CUDA path's accept/reject decisions (`_teacher_force`);
 where the plain path would have decided otherwise, the change of f
 must be a tie (`_is_tie`, TIE_K).
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
kernel not named for the path must have launched 0 times. A kernel's
`launches` in the kernels line sums its main-path launches over the
fleets (K4b and K6, on no tracker path, count their kernel phase's). Every failed
check raises, so the script exits non-zero and prints no ok line. The
last line is {"ok": true, "device": {...}}; the line before it is the JSON
summary of the kernels.
"""
import collections
import json
import re
import statistics
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
# an LM decision of the plain path that differs from the CUDA path's is a
# tie when |f_new - f_prev| <= TIE_K * EPS32 * f's rounding scale at the
# step (`_is_tie`, `_f_scale`)
TIE_K = 16
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
# cubic, cubic_bspl) per mode, under the chain kernel's register classes
# (`csrc/lk_fused_chain.cu:min_blocks`): the blurred taps and the other
# state sizes leave them as they are (NVIDIA H100 80GB HBM3, CUDA 12.8).
# The shared-window argument (`win_b`) took ncc@cubic from 123 to 126 of
# its 128 and left every other count as it was
REGS_S8 = {("ssd", False, False): (53, 80, 80),
           ("ncc", False, False): (64, 126, 104),
           ("ssd", True, False): (80, 80, 80),
           ("ncc", True, False): (79, 80, 80),
           ("ssd", False, True): (64, 80, 80)}
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
# the plain-path check's planted fault: the CUDA path updates on frames
# one column off (as a window read one column off its origin would be),
# which moves every tracker by about a pixel and must fail the check. (A
# generator scaled by 1.001 does not: it reparametrises the warp and its
# Jacobian alike, and the Gauss-Newton fixed point stays where it is)
PLAIN_PATH_FAULT = "frames one column off"
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


# slice 8: the generic LK path (no chain kernel), each fleet's B
B_SPLINE = 256           # bench_extra.py spline row
GENERIC_WINDOWS = 1      # timed windows of STEPS updates (host-bound)
B_ROUTING = 256          # the 3-update routing runs of the other options
MASKED_MAX_LAUNCHES = sum(
    min(sum(n for _, n in SCHEDULE[:k + 1]), MAX_ITERS)
    for k in range(len(SCHEDULE))) + MAX_ITERS
# GT readings of the slice-8 legs: the JAX package on the CPU over the
# same legs and the whole fleet (scripts/port_generic_reference_leg.py
# with n_trackers = B): the generic fleets' trackers spread too widely for
# 8 of them to stand for the fleet (spline50: a 50-DOF spline fitted to a
# projective leg, its first 8 trackers 0.7091 px in both packages; iclk:
# plain Gauss-Newton on the cached self0 Hessian loses trackers in the
# JAX package too, its first 8 reading 0.1632). Per frame:
# eslm_ncc_generic 0.1614, 0.1372, 0.125, 0.1059, 0.1011; spline50 0.939,
# 1.0802, 0.7917, 0.9985, 1.4748; iclk_ssd 0.2502, 0.5218, 20.465,
# 1.5715, 6.4461; iclm_ssd 0.1286, 0.1041, 0.0919, 0.0775, 0.0809
GENERIC_GT_READING_PX = {"eslm_ncc_generic": 0.1261, "spline50": 1.0568,
                         "iclk_ssd": 5.8509, "iclm_ssd": 0.0966}
# iclk_ssd's mean moves ~0.08 px with each tracker lost, so its leg is held
# by the trackers it keeps and the number it loses (`_gt_leg_lost`): in
# the JAX package on the CPU the median per frame reads 0.1095, 0.0989,
# 0.1018, 0.0869, 0.0771 px and 30 of 1,280 trackers are lost
# (scripts/port_generic_reference_leg.py 1280 iclk_ssd). A tracker on an
# unstable trajectory may go either way
# under another summation order: the card may lose LOST_MARGIN of the
# fleet more (13 of 1,280); a fault that lowers the tracking of the fleet
# moves its median or loses far more.
GENERIC_GT_LOST = {"iclk_ssd": (0.0948, 30)}
LOST_PX = 1.0
LOST_MARGIN = 0.01


def generic_family():
    """The slice-8 fleets on the generic LK path: {name: (SM key, AM, SSM
    key, B, configuration, GT SSM key)}: `__graft_entry__.entry()`'s
    configuration (eslm/ncc/8, `interp="linear"`, `epsilon=0.01`, no
    crop, 10 iterations) at the esm_ncc row's width and B, the spline50
    row (`bench_extra.py:475-491`, its leg a homography sequence the
    spline approximates) and ICLK on the headline's shapes."""
    return {
        "eslm_ncc_generic": ("eslm", "ncc", "8", B_SLICE2,
                             dict(resx=RES, resy=RES, max_iters=MAX_ITERS,
                                  interp="linear", epsilon=0.01), "8"),
        "spline50": ("fclk", "ssd", "spline", B_SPLINE,
                     dict(resx=32, resy=32, max_iters=5, epsilon=0.0,
                          interp="linear_mm", crop=CROP), "8"),
        "iclk_ssd": ("iclk", "ssd", "8", B, slice_cfg(), "8"),
    }


def routing_family():
    """Every other slice-8 key and option, 3 updates each at B_ROUTING:
    {name: (SM key, AM, SSM key, configuration, frame, launches per
    update by kernel)}. `frame` is "gray", "rgb" (the 3-channel scene) or
    "five" (5 channels). The launches name the path the JAX package's
    `_fused_ok` takes (`mtf_tpu/sm/lk.py:299-332`): the chain kernel's
    mode 10 times per update, or no launch on the generic path; a pair
    (lo, hi) bounds the launches per update where done masks stop early."""
    base, rk = slice_cfg(), rklt_cfg()
    gen = {}
    # (iclm runs in `generic_family`'s phase, on iclk's shapes)
    out = {f"{k}_ssd": (k, "ssd", "8", base, "gray", gen)
           for k in ("aesm", "falk", "ialk", "fcsd", "aelm", "falm", "ialm")}
    out.update({
        "haclk_ssd": ("haclk", "ssd", "8", base, "gray",
                      {"ssd": MAX_ITERS}),
        "fclm_ssd": ("fclm", "ssd", "8", base, "gray", {"ssd": MAX_ITERS}),
        # done masks: each phase loops until its last active tracker
        # reaches the phase's bound (a tracker done early in a coarse phase
        # resumes from its own count at full resolution), so up to the sum
        # of the phases' bounds, 6 + 9 + 10
        "fclm_ssd_eps": ("fclm", "ssd", "8", dict(base, epsilon=0.01),
                         "gray", {"ssd": (1, MASKED_MAX_LAUNCHES)}),
        "gric_ssd": ("gric", "ssd", "8", rk, "gray", {"grid_flow@linear": 2}),
        "fclk_ssd_self0": ("fclk", "ssd", "8", dict(base, hess_type="self0"),
                           "gray", {"ssd": MAX_ITERS}),
        "fclk_ssd_std": ("fclk", "ssd", "8", dict(base, hess_type="std"),
                         "gray", {"ssd": MAX_ITERS}),
        "fclk_ncc_std": ("fclk", "ncc", "8", dict(base, hess_type="std"),
                         "gray", gen),
        "fclk_ssd_std2": ("fclk", "ssd", "8", dict(base, hess_type="std2"),
                          "gray", gen),
        "esm_ncc_diff_of_jacs": ("esm", "ncc", "8",
                                 dict(base, jac_type="diff_of_jacs"),
                                 "gray", gen),
        "rklt_ssd_spi": ("rklt", "ssd", "8", dict(rk, enable_spi=True),
                         "gray", {"grid_flow@linear": 2}),
        "fclk_mcncc": ("fclk", "mcncc", "8", base, "rgb", gen),
        "fclk_mcssd_5ch": ("fclk", "mcssd", "8", base, "five", gen),
        "fclk_ssd_nearest": ("fclk", "ssd", "8", dict(base, interp="nearest"),
                             "gray", gen),
        "fclk_ssd_no_crop": ("fclk", "ssd", "8", dict(base, crop=None),
                             "gray", {"ssd": MAX_ITERS}),
        "fclk_ssd_tps": ("fclk", "ssd", "tps", base, "gray", gen),
    })
    for spi in ("pix_diff", "gradient", "gftt"):
        out[f"esm_ssd_spi_{spi}"] = ("esm", "ssd", "8",
                                     dict(base, spi_type=spi), "gray", gen)
    return out


# slice 9: the particle filter and nearest-neighbour search, each at its
# bench_extra.py row (pf500: `bench_pf500`, :297-332; nn1k: `bench_nn1k`,
# :335-360); the GT legs run at GT_SEEDS (the `seed` option: PF's and
# NN's draws)
B_PF = 128
B_NN = 256
GT_SEEDS = (0, 1, 2)
STOCH_WINDOWS = 1        # timed windows of STEPS updates (host-bound)
B_STOCH_ROUTING = 16     # the 3-update routing runs of the other options
B_NN_AM_FEAT = 8         # nn_dist_feat="am" with MI: 80 KB per sample
PF500_CFG = dict(resx=25, resy=25, pf_n_particles=500, enable_lm=True,
                 max_iters=10, interp="linear_mm", crop=256,
                 pf_score_stride=4, pf_score_blur=True, pf_rescore_top_k=64,
                 pf_pix_sigma=2.0, pf_score_downsample=True,
                 pf_rescore_crop=160, coarse_pt_iters=((4, 3), (2, 3)))
NN1K_CFG = dict(resx=25, resy=25, nn_n_samples=1000, enable_lm=True,
                max_iters=10, interp="linear_mm", crop=224, n_bins=32,
                coarse_pt_iters=((2, 5),), nn_dist_feat="raw")


# GT readings of the slice-9 legs: the JAX package on the CPU over the
# same legs and the whole fleet, at each of GT_SEEDS
# (scripts/port_stochastic_reference_leg.py). Both rows lose trackers
# (beyond LOST_PX on some frame) in the JAX package, so each is held by
# the median of its per-frame corner errors and the number it loses, as
# GENERIC_GT_LOST holds iclk_ssd, each to its worst seed. pf500 seeds
# 0/1/2: mean 0.1758, 0.1865, 0.1789 px; median 0.1163, 0.1159, 0.1160;
# lost 8, 9, 7 of 128 (trackers 3, 46, 56, 84 in all three). nn1k: mean
# 1.2261, 1.3612, 1.5378 px; median 0.4287, 0.4431, 0.4891; lost 145,
# 150, 159 of 256 (the smooth small targets where MI's refiner stalls,
# `bench_extra.py:341-354`)
STOCH_GT_LOST = {"pf500": (0.1163, 9), "nn1k": (0.4891, 159)}
STOCH_GT_MEAN_PX = {"pf500": (0.1758, 0.1865, 0.1789),
                    "nn1k": (1.2261, 1.3612, 1.5378)}
PROFILED_UPDATES = 3


def stochastic_family():
    """The slice-9 rows: {name: (SM key, AM, SSM key, B, configuration)}."""
    return {"pf500": ("pffc", "ssim", "8", B_PF, PF500_CFG),
            "nn1k": ("nnic", "mi", "8", B_NN, NN1K_CFG)}


def stochastic_routing():
    """Every other slice-9 key and option, 3 updates each: {name: (SM
    key, AM, SSM key, B, configuration, launches per update by
    kernel)}. The PF options on pf500's PF alone, the NN options on nn1k's
    NN alone, the keys at pf500's or nn1k's options (pfrk and nnrk on the
    rklt row's grid and refiner, which launch K5 twice and the ssd_esm
    chain kernel 10 times per update), the AMs on FCLK's generic path."""
    pf = {k: v for k, v in PF500_CFG.items()
          if k not in ("enable_lm", "coarse_pt_iters")}
    nn = {k: v for k, v in NN1K_CFG.items()
          if k not in ("enable_lm", "coarse_pt_iters")}
    b = B_STOCH_ROUTING
    # the PF options three or two to a run (each run 3 updates: the
    # phase's time goes to the runs' count, not their B)
    out = {f"pf_{n}": ("pf", "ssim", "8", b, dict(pf, **o), {})
           for n, o in (("ar1_additive_corner", dict(
                            pf_dynamic_model="ar1",
                            pf_update_type="additive",
                            pf_mean_type="corner")),
                        ("lik_am_resampling_none_best", dict(
                            pf_likelihood="am", pf_resampling="none",
                            pf_mean_type="best")),
                        ("lik_reciprocal_ssm_sigmas", dict(
                            pf_likelihood="reciprocal", pf_ssm_sigmas=(
                                (0.02,) * 8, (0.005,) * 8, (0.01,) * 8))),
                        ("jacobian_as_sigma",
                         dict(pf_jacobian_as_sigma=True)))}
    out.update({
        # the online additions on both graph keys
        "gnn_add_samples": ("gnn", "mi", "8", b,
                            dict(nn, nn_add_samples_gap=1), {}),
        "fgnn_add_samples": ("fgnn", "mi", "8", b,
                             dict(nn, nn_add_samples_gap=2), {}),
        # MI's binned features, the exact search's online additions
        "nn_am_feat_add_samples": ("nn", "mi", "8", B_NN_AM_FEAT,
                                   dict(nn, nn_dist_feat="am",
                                        nn_add_samples_gap=1), {}),
        "pfsl3": ("pfsl3", "ncc", "8", b, dict(
            interp="linear_mm", crop=256, pf_score_stride=4,
            pf_score_blur=True, pf_rescore_top_k=64),
            {"ncc": (1, MAX_ITERS)}),
        "pfk": ("pfk", "ssim", "8", b, pf, {}),
        "pfkfc": ("pfkfc", "ssim", "8", b, PF500_CFG, {}),
        "nnk": ("nnk", "mi", "8", b, nn, {}),
        "nnkic": ("nnkic", "mi", "8", b, NN1K_CFG, {}),
        "pfrk": ("pfrk", "ssd", "8", b, dict(
            rklt_cfg(), pf_n_particles=500, pf_score_stride=4,
            pf_score_blur=True, pf_rescore_top_k=64, pf_pix_sigma=2.0,
            pf_score_downsample=True),
            {"ssd_esm": MAX_ITERS, "grid_flow@linear": 2}),
        "nnrk": ("nnrk", "ssd", "8", b, dict(
            rklt_cfg(), nn_n_samples=1000, nn_dist_feat="raw"),
            {"ssd_esm": MAX_ITERS, "grid_flow@linear": 2}),
    })
    # the four AMs on FCLK with LM on: plain Gauss-Newton on them sends
    # some trackers to NaN within 3 updates in the JAX package too (3
    # updates on the scene at B = 32: KLD 1, CCRE 18 of 32 trackers; none
    # with LM). LKLD's blocks need the full grid, so LKLD and CCRE take
    # no coarse phases (LKLD's raise in the JAX package too)
    lm = dict(slice_cfg(), enable_lm=True)
    out.update({
        "fclk_spss": ("fclk", "spss", "8", b, lm, {}),
        "fclk_kld": ("fclk", "kld", "8", b, lm, {}),
        "fclk_lkld": ("fclk", "lkld", "8", b,
                      dict(lm, coarse_pt_iters=()), {}),
        "fclk_ccre": ("fclk", "ccre", "8", b,
                      dict(lm, coarse_pt_iters=()), {}),
    })
    return out


# slice 10: the remaining AMs and ILMs, LP, RegNet, the hierarchical SMs
# and the line tracker; each fleet at the B of the row its configuration
# comes from
B_GTRN = 256             # RegNet (gtrn): 3,000 samples of 2,500 points
B_SLICE10_ROUTING = 16   # the 3-update routing runs of the other options
FULL_GRID_AMS = ("ngf", "lscv", "lrscv", "dfm")
# GT readings of the slice-10 legs: the JAX package on the CPU over the
# same legs (scripts/port_slice10_reference_leg.py). hesm over its first 8
# trackers: mean 0.0993 px (per frame 0.1145, 0.1052, 0.1067, 0.081,
# 0.0893). The others lose trackers in the JAX package too, so each is
# held by the median of its per-frame errors and the number it loses
# (`_gt_leg_lost`), over the whole fleet: line 1.1316 px (per frame
# 1.4764, 1.1679, 0.6861, 0.7339, 1.5938; mean 1.4694), 354 of 384 lost
# (the line snap moves most centres); fclk/ssd + pgb 0.1003 px (per frame
# 0.1265, 0.108, 0.1076, 0.0876, 0.0718; mean 0.2161), 154 of 1,024 lost.
# esm/rscv: the JAX package loses 1,023 of 1,024 trackers (median 75.4563
# px; per frame 23.9648, 42.9865, 68.7344, 100.0009, 141.5949: RSCV's
# 8-bin remap biases every ESM step, and the trackers drift off in both
# packages); from the second frame on they part chaotically between any
# two summation orders (the port on the CPU against the JAX package, the
# first 64 trackers: median 17.888 / 17.914 px on frame 1, 102.757 /
# 56.995 on frame 4), so its leg is held on frame 1, the median there
# within `gt_limit` of the JAX package's (SLICE10_GT_FIRST_FRAME; with
# its count non-finite, below). lpfc
# and gtrn, whose draws differ between the packages, over their first
# trackers at each of GT_SEEDS (the card runs the same trackers at the
# same seeds; SLICE10_LEARNED_GT: the trackers, the JAX medians per seed,
# the most lost; RegNet's JAX reading on the CPU samples its 3,000 views
# per tracker by dense matmuls over the whole frame, ~40 s and ~6 GB a
# tracker, so gtrn's leg takes 16): each of the card's seeds is another
# sample of the same distribution, so its median is held to the worst
# JAX seed's plus
# the JAX seeds' spread (`learned_limit`; at least `gt_limit` of it), its
# count lost to the most the JAX seeds lose plus LOST_MARGIN. lpfc
# 0.0838, 0.0839, 0.0839 px, none of 32 lost; gtrn (RegNet alone, no
# refiner, 8-px training motion) 3.7821, 3.3730, 3.8892 px (means
# 4.7240, 4.1004, 4.5002), all 16 lost at every seed (beyond 1 px on
# some frame).
# Trackers whose corners go non-finite: none in any JAX leg above or in
# an earlier fleet's, but for esm/rscv. Its trackers drift hundreds to
# thousands of px off the frame, where ESM's Hessian is so ill-conditioned
# that a float32 Cholesky pivot may go negative: whether it does turns on
# rounding. The JAX package sends 140 of 1,024 non-finite on its leg,
# 137 and 149 on the leg's frames 1 and 2 ulps up (57 and 61 trackers
# flip), and 283 after the timed run's 23 static updates (290 and 300 on
# the scene 1 and 2 ulps up, 173 and 185 flips). If each tracker's
# outcome is an independent draw, the flips between two runs estimate
# the variance of the difference of their counts; the card's count is
# held to the JAX package's plus 3 standard deviations
# (`not_finite_limit`: (count, the most flips)). gtrn's timed run (not
# its legs): RegNet's step, once a tracker has left the frame, can grow
# its similitude's scale without end until float32 overflows (10^36 px
# and more before the NaN). Which trackers do turns on the nets, so on
# the draws, which differ between the packages: from the port's nets
# trained on the CPU, the JAX package's updates send 3 of 256 trackers
# non-finite (49, 83, 93), the port's 3 (83, 85, 93). The card trains
# on its own draws, and for counts of independent draws the variance of
# the difference is their sum, twice 3.
SLICE10_GT_READING_PX = {"hesm_ssd": 0.0993}
SLICE10_GT_LOST = {"line_ssd": (1.1316, 354), "fclk_ssd_pgb": (0.1003, 154)}
SLICE10_GT_FIRST_FRAME = {"esm_rscv": (23.9648, (140, 61))}
SLICE10_LEARNED_GT = {
    "lpfc_ssd": (32, (0.0838, 0.0839, 0.0839), 0, (0, 0)),
    "gtrn_ssd": (16, (3.7821, 3.3730, 3.8892), 16, (0, 0))}
SLICE10_PROFILED = ("hesm_ssd", "lpfc_ssd", "esm_rscv")
# the timed run's non-finite trackers (WARMUP + STEPS static updates;
# the other fleets: none)
SLICE10_NOT_FINITE = {"esm_rscv": (283, 185), "gtrn_ssd": (3, 6)}
# the legs read over the first 8 trackers (the others: the whole fleet)
SLICE10_FIRST8 = ("hesm_ssd",)


def learned_limit(medians) -> float:
    """The median limit of a fleet whose draws differ between the
    packages: the worst JAX seed's median plus the JAX seeds' spread, at
    least `gt_limit` of the worst."""
    worst = max(medians)
    return max(gt_limit(worst), 2 * worst - min(medians))


def slice10_family():
    """The slice-10 fleets: {name: (SM key, AM, SSM key, B, configuration,
    launches per update by kernel)}; an ILM rides in the configuration
    (`create_tracker`'s `ilm`). hesm runs ESM on the translation, then on
    the homography (the chain kernel's ssd_esm mode at S = 2, then 8,
    10 iterations each); lpfc the 3-stage LP on the translation, then
    FCLK (K1); line the rklt row's grid (K5 on 2 levels); esm/rscv and
    fclk/ssd with PGB (S + P = 18) the generic path; gtrn RegNet on the
    similitude (GOTURN's analog: 3,000 samples, hidden 256-128)."""
    return {
        "hesm_ssd": ("hesm", "ssd", "8", B_SLICE2, slice_cfg(),
                     {"ssd_esm:s2": MAX_ITERS, "ssd_esm": MAX_ITERS}),
        "lpfc_ssd": ("lpfc", "ssd", "8", B, slice_cfg(), {"ssd": MAX_ITERS}),
        "line_ssd": ("line", "ssd", "8", B_RKLT, rklt_cfg(),
                     {"grid_flow@linear": K5_PER_UPDATE}),
        "esm_rscv": ("esm", "rscv", "8", B_SLICE2, slice_cfg(), {}),
        "fclk_ssd_pgb": ("fclk", "ssd", "8", B_SLICE2,
                         dict(slice_cfg(), ilm="pgb"), {}),
        "gtrn_ssd": ("gtrn", "ssd", "8", B_GTRN, slice_cfg(), {}),
    }


def slice10_routing():
    """Every other slice-10 key and option, 3 updates each at
    B_SLICE10_ROUTING: {name: (SM key, AM, SSM key, configuration, frame,
    launches per update by kernel)}, `frame` "gray" or "rgb". Each new AM
    and its `mc` key on FCLK (plain Gauss-Newton: none sends a tracker to
    NaN in 3 updates in the JAX package on the CPU,
    `scripts/port_slice10_reference_leg.py routing`; the full-grid AMs
    without coarse phases, which they raise under, as in the JAX package),
    the sums, GB and RBF, PF with GB's photometric walk, the LP keys, hrch
    with FCLK, RegNet on the translation and NN on ZNCC's and DFM's
    features."""
    base = slice_cfg()
    out = {}
    for am in ("nssd", "zncc", "sad", "scv", "rscv", "lscv", "lrscv", "riu",
               "ngf", "pca", "dfm"):
        cfg = dict(base, coarse_pt_iters=()) if am in FULL_GRID_AMS else base
        out[f"fclk_{am}"] = ("fclk", am, "8", cfg, "gray", {})
        out[f"fclk_mc{am}"] = ("fclk", "mc" + am, "8", cfg, "rgb", {})
    pf = {k: v for k, v in PF500_CFG.items()
          if k not in ("enable_lm", "coarse_pt_iters")}
    nn = {k: v for k, v in NN1K_CFG.items()
          if k not in ("enable_lm", "coarse_pt_iters", "n_bins",
                       "nn_dist_feat")}
    out.update({
        "fclk_sum_ssd_ncc": ("fclk", "sum", "8", base, "gray", {}),
        "fclk_sum_zncc_scv": ("fclk", "sum", "8",
                              dict(base, sum_am1="zncc", sum_am2="scv"),
                              "gray", {}),
        "fclk_ssd_gb": ("fclk", "ssd", "8", dict(base, ilm="gb"), "gray",
                        {}),
        "fclk_ssd_rbf": ("fclk", "ssd", "8", dict(base, ilm="rbf"), "gray",
                         {}),
        "pf_ssd_gb_am_sigma": ("pf", "ssd", "8", dict(
            pf, ilm="gb", pf_am_sigma=(0.01, 1.0)), "gray", {}),
        "lp_ssd": ("lp", "ssd", "8", base, "gray", {}),
        "lpic_ssd": ("lpic", "ssd", "8", base, "gray", {}),
        "lpes_ssd": ("lpes", "ssd", "8", base, "gray",
                     {"ssd_esm": MAX_ITERS}),
        "hrch_fclk_ssd": ("hrch", "ssd", "8", dict(base, hrch_sm="fclk"),
                          "gray", {"ssd:s2": MAX_ITERS, "ssd": MAX_ITERS}),
        "regnet_ssd_2": ("regnet", "ssd", "2", base, "gray", {}),
        "nn_zncc_feat": ("nn", "zncc", "8", nn, "gray", {}),
        "nn_dfm_feat": ("nn", "dfm", "8", nn, "gray", {}),
    })
    return out


# slice 12: the box trackers (the CF and learn families, DFT and TLD) at
# each one's JAX defaults on the scene and the `_corners` boxes; the CF
# fleets at B_CF, the others at B_BOX
B_CF = 1024
B_BOX = 256
B_SLICE12_ROUTING = 16   # the 3-update routing runs of the other options
# The GT leg of every slice-12 fleet is the headline's: the 6-frame
# sequence drawn with the homography (a box tracker has no SSM of its
# own), held by `gt_limit` of the JAX package's reading on the CPU over the
# same leg (`scripts/port_slice12_reference_leg.py`): the first 8
# trackers' mean where none of them is lost, else the whole fleet's
# median and lost count (SLICE12_GT_LOST, `_gt_leg_lost`).
# The readings (the first 8 trackers' mean; else the whole fleet's median
# per frame averaged over the frames, and the lost count): dft 0.0465 px
# (per frame 0.0491, 0.0505, 0.043, 0.0411, 0.0485), none lost; mosse
# 1.1287 px (923 of 1,024 lost), kcf 1.3816 (992), dsst 1.0344 (931), rct
# 1.4188 (251 of 256), mil 1.5046 (252), boost 1.5259 (252), strk 3.2726
# (256), frg 1.6053 (254), tld 0.7243 (178): a box cannot follow the
# sequence's shear and perspective, and the learn trackers step in whole
# feature-frame pixels (1-2.5 image px).
SLICE12_GT_READING_PX = {"dft": 0.0465}
SLICE12_GT_LOST = {"mosse": (1.1287, 923), "kcf": (1.3816, 992),
                   "dsst": (1.0344, 931), "rct": (1.4188, 251),
                   "mil": (1.5046, 252), "boost": (1.5259, 252),
                   "strk": (3.2726, 256), "frg": (1.6053, 254),
                   "tld": (0.7243, 178)}
SLICE12_GT_SSM = "8"
# TLD's occlusion leg (`tests/test_tld.py`'s scene, box, trajectory and
# pyramid): the target hidden by noise on frames 3-7
TLD_OCC_CFG = dict(tld_canon_h=96, tld_canon_w=128, tld_levels=3)
TLD_OCC_TRAJ = ((2, 1), (4, 2), (6, 3)) + ((8, 4),) * 6 + ((10, 5), (12, 6))
TLD_OCC_HIDDEN = (3, 8)
TLD_OCC_FINAL_PX = 12.0
# Re-acquisition after the occluder turns on rounding (the Median Flow leg
# tracks the noise): of the 16 boxes, the JAX package's lone trackers on
# the CPU re-acquire 9 (10, 9 and 9 on the leg's frames 1, 2 and 3 ulps
# up: 1, 2 and 0 trackers flip) and the port's fleet on the CPU 8 (1
# flips; `scripts/port_slice12_reference_leg.py occlusion --nudge 3`). If
# each tracker's outcome is an independent draw, the flips between two
# runs estimate the variance of the difference of their counts; the
# card's count is held to the JAX count less 3 standard deviations (as
# `not_finite_limit`): (count, the most flips).
TLD_OCC_REACQUIRED = (9, 2)


def slice12_family():
    """The slice-12 fleets: {name: (SM key, AM, SSM key, B, configuration,
    launches per update by kernel)}. Each runs its JAX defaults; TLD's
    Median Flow leg takes the mf row's dense taps and window (K5: 3 levels,
    forward and back), DFT the default ESM on the generic path (no kernel,
    as in the JAX package)."""
    mf_cfg = grid_family()["mf"][3]
    out = {k: (k, "ssd", "8", B_CF, {}, {}) for k in ("mosse", "kcf", "dsst")}
    out.update({k: (k, "ssd", "8", B_BOX, {}, {})
                for k in ("rct", "mil", "boost", "strk", "frg", "dft")})
    out["tld"] = ("tld", "ssd", "8", B_BOX, dict(mf_cfg),
                  {"grid_flow@linear": 6})
    return out


def slice12_routing():
    """Every other slice-12 option, 3 updates each at B_SLICE12_ROUTING:
    {name: (SM key, AM, SSM key, configuration, launches per update)}:
    each CF key with its other features, and DFT with FCLK on dense taps,
    which the JAX package's `_fused_ok` sends to the multi-channel chain
    kernel (K4) on the 4-channel descriptor fields, once per iteration
    until its done masks stop it (at most 30)."""
    out = {f"{k}_{f}": (k, "ssd", "8", {"features": f}, {})
           for k, f in (("mosse", "hog"), ("kcf", "gray"), ("dsst", "gray"))}
    out["dft_fclk"] = ("dft", "ssd", "8",
                       dict(dft_sm="fclk", interp="linear_mm"),
                       {"ssd_mc": (1, 30)})
    return out


def _toy_frame(h=64, w=80, seed=0):
    """`__graft_entry__._toy_frame` in numpy (no JAX)."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


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


def _graph_ms(torch, fn, calls=20):
    """Device time of one call of `fn`: `calls` calls captured in a CUDA
    graph (after a warm-up on a side stream), replayed until a timing
    takes >= 50 ms; the median of 5 timings by CUDA events. The host's
    time to launch each call (a kernel wrapper's checks and allocations,
    about as long as a small launch) stays out of it."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    replays = max(3, int(50 / max(_time_ms(torch, graph.replay, 2), 1e-3)))
    times = sorted(_time_ms(torch, graph.replay, replays) for _ in range(5))
    return times[2] / calls


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


def build_specs(tk, gf):
    """Every kernel library, built side by side: the chain kernel per S
    and, with the bfloat16-operand flag, per S again; K6; the grid flow
    with and without the flag."""
    return ([("lk_fused_chain", tk.build_defines(st, bf))
             for bf in (False, True) for st in STATE_DIMS]
            + ["lk_fused_gn", ("grid_flow", gf.build_defines(False)),
               ("grid_flow", gf.build_defines(True))])


def _bf16_usage(tk, gf, libs):
    """The flagged libraries' instantiations: {(S, am, esm, mc, kind):
    (registers, spill stores, spill loads)} of the chain kernel's plain
    taps at every S and {(K, kind): ...} of the grid flow; prints each
    and fails on a spill or a missing instantiation."""
    from mtf_tpu_torch.ops.kernels import _build
    chain, spilled = {}, []
    for st in STATE_DIMS:
        got = _ptxas_usage(libs[_build.lib_key(
            "lk_fused_chain", tk.build_defines(st, True))].log)
        want = {i + (False,) for i in tk.INSTANTIATIONS}
        _check(set(got) == want, f"bf16 chain library S={st}: "
               f"instantiations {sorted(got)}")
        for key, use in got.items():
            chain[(st,) + key[:4]] = use
            mode = tk.mode_name(*key[:4], s=st, bf16=True)
            print(f"ptxas: {_label(*key[:4])} {mode}: {use[0]} registers, "
                  f"spill stores {use[1]} B, spill loads {use[2]} B")
            if use[1] or use[2]:
                spilled.append(mode)
    k5 = _ptxas_k5(libs[_build.lib_key("grid_flow",
                                       gf.build_defines(True))].log)
    _check(sorted(k5) == sorted(gf.INSTANTIATIONS),
           f"bf16 grid-flow instantiations {sorted(k5)}")
    for (k, kind), use in sorted(k5.items()):
        print(f"ptxas: K5{'' if kind == 'linear' else 'c'}+bf16 "
              f"grid_flow<{k}, {kind}>: {use[0]} registers, spill stores "
              f"{use[1]} B, spill loads {use[2]} B")
        if use[1] or use[2]:
            spilled.append(f"grid_flow<{k}, {kind}>+bf16")
    _check(not spilled, f"bf16 instantiations spill: {spilled}")
    return {"chain": chain, "k5": k5}


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
    input read once: the window pixels its points' taps cover (a window
    shared by every tracker, once over all of them) (2x2
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
    if win.shape[0] > 1 and win.stride(0) == 0:
        # one window (the shared frame): its pixels are read once
        cover = torch.zeros(hc * wc, dtype=torch.bool, device=win.device)
        cover.scatter_(0, idx.flatten(), True)
    else:
        cover = torch.zeros((b, hc * wc), dtype=torch.bool,
                            device=win.device)
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
    chunks = tk.ref_chunks(ph.shape[0], ph.shape[-1], *window.shape[-2:])
    if len(chunks) > 1:
        # the plain form's chunks (the no-crop sub-grid's shared frame)
        parts = [chain_sum_scales(
            torch, tk, (window[c], M0[c], gens, ph[c], templ[c]), am,
            None if j0 is None else j0[c], kind, blur) for c in chunks]
        return [torch.cat(x) for x in zip(*parts)]
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
        (PLANTED_FAULTS[0], (_bf16_window(args[0]),) + tuple(args[1:])),
        (PLANTED_FAULTS[1], tuple(args[:2]) + (third,) + tuple(args[3:]))])


def _bf16_window(win):
    """`win` rounded to bfloat16; one shared by every tracker (batch stride
    0) stays one window."""
    if win.shape[0] > 1 and win.stride(0) == 0:
        return win[0].bfloat16().float().expand(win.shape)
    return win.bfloat16().float()


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


def _chain_row(torch, tk, args, j0, am, esm, kind, blur, name, card,
               plain_reps, bf16=False, **meta):
    """One chain-kernel launch against its plain form on the card (val
    within 1e-3; raw sums by `raw_verdict`, its rounding floor at S != 8
    only, with the planted faults wherever it was needed; NCC's combined
    g and H within NCC_COMBINED_REL), the kernel timed by `_graph_ms`,
    the plain form by CUDA events, with the
    launch's bound; `bf16`, both with the bfloat16-operand flag (the
    window in `args` already rounded). Returns the row."""
    s = args[2].shape[0]

    def run(*a):
        return tk.lk_fused_chain_raw(*a, am=am, j0=j0, kind=kind, blur=blur,
                                     bf16=bf16)

    got = run(*args)
    torch.cuda.synchronize()
    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind, blur=blur,
                                 bf16=bf16)
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
    row["ms"] = _graph_ms(torch, lambda: run(*args))
    row["plain_ms"] = _time_ms(torch, lambda: tk.lk_fused_chain_ref(
        *args, am=am, j0=j0, kind=kind, blur=blur, bf16=bf16), plain_reps)
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
                  n_points=N_POINTS, plain_reps=5):
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
                f"{label} {mode} C={c} N={n} B={b}", card, plain_reps, b=b,
                c=c)
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
            f"N={n} B={b} window {SUBGRID_CROP}", card, 5, b=b, c=1)
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
    their norms), timed as `_chain_row` times, with its bound. Returns
    {(S, kind, crop): row}."""
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
                row["ms"] = _graph_ms(torch, lambda: run(*args))
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


# launches per kernel instantiation over every fleet's main path (`_fleet`)
MAIN_PATH_LAUNCHES = collections.Counter()


def _fleet(torch, key, am, b, card, corners, frame_d, dev, tk, gf, expect,
           windows=WINDOWS, warmup=WARMUP, interp="linear_mm", cfg=None,
           label=None, ssm="8", moving=False, timing=None,
           max_not_finite=0):
    """The fleet's main path: `warmup` updates, then `windows` timed
    windows of STEPS updates; the launch counts are zeroed just before
    and read just after (and added to MAIN_PATH_LAUNCHES), and each kernel
    must have launched exactly `expect[name]` times per update (0 for any
    name not in `expect`). `moving`: the updates alternate between the
    frame and the frame shifted by (1, 1) px, so that done masks
    (`epsilon > 0`) see motion in every update. `timing`, a dict, takes
    the seconds of the fleet's `initialize` (to the card's last kernel)
    as "init_s", and the number of trackers whose corners are not finite
    as "not_finite"; at most `max_not_finite` may be (`not_finite_limit`:
    none, unless the JAX package's run of the fleet has such trackers
    too)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    label = label or f"{key}/{am} {interp}"
    sm = create_tracker(key, am, ssm, device=dev,
                        **(cfg if cfg is not None else cfg_of(key, interp)))
    fleet = TrackerFleet(sm, donate=True)
    _zero_counts(tk, gf)
    t_init = time.perf_counter()
    states = fleet.initialize(frame_d, corners)
    if timing is not None:
        torch.cuda.synchronize()
        timing["init_s"] = time.perf_counter() - t_init
    frames = [frame_d, torch.roll(frame_d, (1, 1), (0, 1)) if moving
              else frame_d]
    for i in range(warmup):
        states = fleet.update(states, frames[(i + 1) % 2])
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(STEPS):
            states = fleet.update(states, frames[i % 2])
        torch.cuda.synchronize()
        rates.append(b * STEPS / (time.perf_counter() - t0))
    counts = _counts(tk, gf)
    MAIN_PATH_LAUNCHES.update(counts)
    n_updates = warmup + windows * STEPS
    for name, got in counts.items():
        want = expect.get(name, 0)
        lo, hi = want if isinstance(want, tuple) else (want, want)
        _check(lo * n_updates <= got <= hi * n_updates,
               f"{label}: {name} launched {got} times in {n_updates} updates "
               f"(expected {want} per update)")
    ok = torch.isfinite(fleet.corners(states)).flatten(1).all(-1)
    not_finite = int((~ok).sum())
    if timing is not None:
        timing["not_finite"] = not_finite
    _check(not_finite <= max_not_finite,
           f"{label}: {not_finite} trackers' corners not finite (limit "
           f"{max_not_finite})")
    fps = sorted(rates)[len(rates) // 2] if rates else None
    print(f"fleet {label} B={b}: "
          + (f"{fps:.1f} frames/s median of {[round(r, 1) for r in rates]}"
             if rates else "untimed")
          + f" ({card}); launches "
          + ", ".join(f"{k} {counts[k]} = {v} x {n_updates} updates"
                      for k, v in expect.items()))
    return sm, fps, {k: counts[k] for k in expect}


def _gt_errors(sm, frame0, corners, gt_ssm=None):
    """6-frame synthetic sequence with exact GT, drawn with the tracker's
    SSM or `gt_ssm` (a key), tracked by a fleet of `sm`: (each tracker's
    mean corner error per frame (B, 5), the frames)."""
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    ssm = sm.ssm if gt_ssm is None else get_ssm(gt_ssm, device=sm.device)
    frames, gt = synthetic_sequence(frame0, corners, ssm, n_frames=6,
                                    sigma_scale=0.004, seed=3)
    fleet = TrackerFleet(sm)
    states = fleet.initialize(frames[0], corners)
    errs = []
    for t in range(1, len(frames)):
        states = fleet.update(states, frames[t])
        c = fleet.corners(states).cpu().numpy()          # (B, 2, 4)
        errs.append(np.linalg.norm(
            np.transpose(c, (0, 2, 1)) - gt[t], axis=-1).mean(-1))
    return np.stack(errs, 1), frames


def _gt_leg(sm, frame0, corners, limit, label, gt_ssm=None):
    """`_gt_errors`' leg, held by its mean corner error."""
    e, frames = _gt_errors(sm, frame0, corners, gt_ssm)
    errs = e.mean(0).tolist()
    gt_px = float(np.mean(errs))
    _check(np.isfinite(gt_px) and gt_px <= limit,
           f"{label} GT mean corner error {gt_px} px (limit {limit})")
    print(f"{label} GT: mean corner error {gt_px:.4f} px over {len(errs)} "
          f"frames (per frame {[round(e, 4) for e in errs]}), limit {limit}")
    return gt_px, frames


def not_finite_limit(reading=(0, 0)) -> int:
    """The most trackers of a fleet whose corners may end non-finite,
    where the JAX package's run of the same fleet on the CPU reads
    `reading` = (non-finite trackers, v): its count plus 3 standard
    deviations of the difference between two runs' counts, v the
    variance (0 where no tracker's outcome turns on rounding: then
    none beyond the JAX package's, 0 for every fleet but two)."""
    k, v = reading
    return k + int(np.ceil(3 * np.sqrt(v)))


def _held_errors(e, reading, label):
    """A leg's errors `e` (B, 5) with its non-finite trackers held to the
    JAX package's `reading` (`not_finite_limit`) on the same leg, and
    then taken as lost, their errors infinite: (the errors, the number
    non-finite)."""
    bad = int((~np.isfinite(e)).any(1).sum())
    limit = not_finite_limit(reading)
    print(f"{label} GT: {bad} of {len(e)} trackers not finite (limit "
          f"{limit}, the JAX package {reading[0]})")
    _check(bad <= limit, f"{label} GT: {bad} trackers not finite "
           f"(limit {limit})")
    return np.where(np.isfinite(e), e, np.inf), bad


def _gt_leg_lost(sm, frame0, corners, reading, label, gt_ssm=None,
                 limit=None):
    """`_gt_errors`' leg, held by the trackers it keeps and the number it
    loses, for a fleet that loses some in the JAX package too (`reading`
    = (median px, lost[, (non-finite, v)]), its reading on the same leg):
    the trackers whose corners went non-finite are held to the JAX
    package's count (none where `reading` gives none; `_held_errors`) and
    count as lost; a tracker is lost when its error exceeds LOST_PX on
    some frame.
    The mean of the per-frame medians is held to `gt_limit` of the JAX
    reading's (`limit`, where given, replaces it), the number lost to the
    JAX package's plus LOST_MARGIN of the fleet. Returns (the median
    reading, the number lost, the mean corner error of the trackers that
    stay finite, the frames)."""
    med_ref, lost_ref, *nf_ref = reading
    limit = gt_limit(med_ref) if limit is None else limit
    e, frames = _gt_errors(sm, frame0, corners, gt_ssm)
    e, _ = _held_errors(e, nf_ref[0] if nf_ref else (0, 0), label)
    med = float(np.median(e, 0).mean())
    lost = np.flatnonzero(e.max(1) > LOST_PX)
    max_lost = lost_ref + int(np.ceil(LOST_MARGIN * len(e)))
    mean = float(e[np.isfinite(e).all(1)].mean())
    print(f"{label} GT: median corner error {med:.4f} px (per frame "
          f"{[round(float(x), 4) for x in np.median(e, 0)]}), limit "
          f"{limit}; {len(lost)} of {len(e)} trackers lost "
          f"(> {LOST_PX} px on a frame; limit {max_lost}, the JAX package "
          f"{lost_ref}): {lost.tolist()}; mean {mean:.4f} px")
    _check(np.isfinite(med) and med <= limit,
           f"{label} GT median corner error {med} px (limit {limit})")
    _check(len(lost) <= max_lost, f"{label}: {len(lost)} trackers lost "
           f"(limit {max_lost})")
    return med, len(lost), mean, frames


def _lm_trackers(sm):
    """The LK trackers of `sm` (a tracker or composite) with LM on."""
    from mtf_tpu_torch.sm.lk import LKBase
    return [m for m in sm.modules()
            if isinstance(m, LKBase) and m.prm.enable_lm]


def _f_scale(m, ph, ssm_state, p_am, offset):
    """(B,) the scale of the float32 rounding of LK tracker `m`'s LM
    objective f at a state: sum_i |df/dp_i| |p_i| over the n sampled
    values p_i (each rounds relative to its magnitude) plus n |f| (a sum
    of n terms)."""
    import torch
    patch = m.am.ilm.apply(m._sample(ph.img, m._pts(
        ph.region, ssm_state, torch.zeros_like(ssm_state)), offset,
        False, m.prm.crop)[0], p_am)
    st = ph.am_state._replace(p_am=p_am)
    g = m.am.grad_corrected(st, patch)
    f = m.am.f_corrected(st, patch)
    return ((g.abs() * patch.abs()).flatten(1).sum(-1)
            + patch[0].numel() * f.abs())


def _teacher_force(cuda_sm, cpu_sm):
    """Drive the plain path with the CUDA path's LM decisions: each LM
    tracker of `cuda_sm` records its (accept, done) per iteration (its
    `_lm_decide`, patched on the instance), and its twin in `cpu_sm`
    takes them in the same order in place of its own. Where the plain
    path's own decision differs, the twin logs the tracker, the relative
    change of f and whether that change is a tie: within TIE_K float32
    epsilons of f's rounding scale (`_is_tie`, `_f_scale`). Returns
    (begin_frame, log, restore): call begin_frame() before each frame's
    pair of updates and restore() at the end."""
    pairs = list(zip(_lm_trackers(cuda_sm), _lm_trackers(cpu_sm)))
    queues = [collections.deque() for _ in pairs]
    log = {"disagree": [], "calls": 0, "f_dev": 0.0}
    frame = [0]

    def recorder(m, q):
        def decide(ph, ssm_state, p_am, offset, f_new, f_prev, moved):
            accept, done = type(m)._lm_decide(m, ph, ssm_state, p_am, offset,
                                              f_new, f_prev, moved)
            q.append((accept.cpu(), done.cpu(), f_new.cpu()))
            return accept, done
        return decide

    def forcer(m, q):
        def decide(ph, ssm_state, p_am, offset, f_new, f_prev, moved):
            accept, _ = type(m)._lm_decide(m, ph, ssm_state, p_am, offset,
                                           f_new, f_prev, moved)
            a, d, f_cuda = q.popleft()
            log["calls"] += 1
            df = (f_new - f_prev).double()
            scale = _f_scale(m, ph, ssm_state, p_am, offset).double()
            # how far the two paths' f of the same step part, in units of
            # the tie bound
            dev = ((f_new - f_cuda).double().abs()
                   / (TIE_K * EPS32 * scale).clamp(min=1e-30))
            log["f_dev"] = max(log["f_dev"], float(dev.max()))
            for i in (accept != a).nonzero().flatten().tolist():
                log["disagree"].append({
                    "frame": frame[0], "call": log["calls"], "tracker": i,
                    "rel_df": float(df[i] / f_prev[i].abs().clamp(
                        min=1e-30)),
                    "tie_bound_rel": float(TIE_K * EPS32 * scale[i]
                                           / f_prev[i].abs().clamp(
                                               min=1e-30)),
                    "tie": _is_tie(float(df[i]), float(scale[i]))})
            return a, d
        return decide

    for (g, c), q in zip(pairs, queues):
        g._lm_decide, c._lm_decide = recorder(g, q), forcer(c, q)

    def begin_frame():
        frame[0] += 1

    def restore():
        for g, c in pairs:
            del g._lm_decide, c._lm_decide
    return begin_frame, log, restore


def _is_tie(df: float, scale: float) -> bool:
    """An LM decision's change of f, |f_new - f_prev|, is a tie when it is
    within what float32 rounding can move f by: `scale` is f's rounding
    scale at the step (`_f_scale`: sum_i |df/dp_i| |p_i| over the
    n sampled values p_i, each of which rounds relative to its magnitude,
    plus n |f| for the sum of n terms), and a sampled value takes ~8
    roundings (4 taps, their weights, two passes), on each of the two
    paths: TIE_K = 2 x 8 epsilons of the scale."""
    return abs(df) <= TIE_K * EPS32 * scale


def _plain_path_check(sm, key, am, frames, corners, label,
                      interp="linear_mm", cfg=None, ssm="8", boundary=None,
                      planted=None, lm_ties=True):
    """The same trackers on the plain path (CPU tensors: the kernels'
    plain forms) agree with the CUDA path, each tracker within
    PLAIN_PATH_TOL_PX; a tracker named in `boundary` {index: why} is held
    to PLAIN_PATH_BOUNDARY_TOL_PX instead. The grid's RANSAC draw comes
    from a generator on each path's device, so each CPU grid is handed its
    CUDA twin's draws (each CPU LP stage its training draws), and an LM
    tracker's accept/reject decisions are the
    CUDA path's (`_teacher_force`): where the plain path would have
    decided otherwise, the change of f must be a tie (`_is_tie`).
    `planted` names a fault (PLAIN_PATH_FAULT: the CUDA path updates on
    frames rolled by one column) to run with, which the check must
    reject: it then fails unless the verdict is a failure. `lm_ties`
    False reports the LM decisions the plain path would have taken
    otherwise without holding them to ties (`interp_bf16`, whose weights'
    rounding parts the two paths' objectives beyond float32 ties: ROADMAP
    Queue 3, item 18). Returns (the largest difference of the other
    trackers, the disagreements, the verdict)."""
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
    # the LP stages' training draws, likewise
    from mtf_tpu_torch.sm.lp import LP
    for lp_cuda, lp_cpu in zip(
            [m for m in sm.modules() if isinstance(m, LP)],
            [m for m in cpu_sm.modules() if isinstance(m, LP)]):
        lp_cpu._draw = (lambda draw: lambda i: draw(i).cpu())(lp_cuda._draw)
    begin_frame, log, restore = _teacher_force(sm, cpu_sm)
    if planted is not None:
        _check(planted == PLAIN_PATH_FAULT, f"no such fault {planted}")
    sub = corners[:PLAIN_PATH_TRACKERS]
    try:
        st_g = sm.initialize(frames[0], sub)
        st_c = cpu_sm.initialize(frames[0].cpu(), sub)
        per = np.zeros(len(sub))
        for t in range(1, 3):
            begin_frame()
            st_g = sm.update(st_g, frames[t] if planted is None
                             else frames[t].roll(1, dims=1))
            st_c = cpu_sm.update(st_c, frames[t].cpu())
            d = (sm.corners(st_g).cpu() - cpu_sm.corners(st_c)).abs()
            per = np.maximum(per, d.flatten(1).amax(1).numpy())
    finally:
        restore()
    named = np.isin(np.arange(len(sub)), list(boundary))
    diff = float(per[~named].max())
    non_ties = [d for d in log["disagree"] if not d["tie"]]
    ok = (diff < PLAIN_PATH_TOL_PX and not (non_ties and lm_ties)
          and all(per[i] < PLAIN_PATH_BOUNDARY_TOL_PX for i in boundary))
    fault = f" (planted: {planted})" if planted else ""
    print(f"{label} plain-path check{fault}: {PLAIN_PATH_TRACKERS} "
          f"trackers, 2 frames, max corner diff {diff:.3g} px, per tracker "
          f"{[float(f'{x:.3g}') for x in per]}"
          + "".join(f"; tracker {i} ({why}) {per[i]:.3g} px (limit "
                    f"{PLAIN_PATH_BOUNDARY_TOL_PX})"
                    for i, why in boundary.items())
          + (f"; teacher-forced LM: {log['calls']} decisions, f of the two "
             f"paths parting by up to {log['f_dev']:.3g} tie bounds, "
             f"{len(log['disagree'])} the plain path would have taken "
             f"otherwise ({len(non_ties)} not ties"
             + ("" if lm_ties else ", not held under interp_bf16") + "): "
             + json.dumps(log["disagree"][:10])
             + (" ..." if len(log["disagree"]) > 10 else "")
             if log["calls"] else "")
          + f"; {'pass' if ok else 'FAIL'}")
    if planted is not None:
        _check(not ok, f"{label}: the planted fault '{planted}' passed the "
               "plain-path check")
    else:
        _check(diff < PLAIN_PATH_TOL_PX,
               f"{label}: CUDA path vs plain path corners differ by {diff} "
               f"px (per tracker {per.tolist()})")
        _check(not (non_ties and lm_ties), f"{label}: LM decisions that "
               f"are not ties: {non_ties}")
        for i, why in boundary.items():
            _check(per[i] < PLAIN_PATH_BOUNDARY_TOL_PX,
                   f"{label}: tracker {i} ({why}) differs by {per[i]} px")
    return diff, log["disagree"], ok


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
               kind="linear", bf16=False):
        calls.append((win, pts, templ, scale, n, n_iters, kind))
        return real(win, pts, templ, scale, n, n_iters, zncc, kind, bf16)

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
    on the card under K5's rule (K5_TOL, K5_OVER_SHARE, K5_MAX), the
    kernel timed by `_graph_ms`, the plain form by CUDA events, and the
    launch's bound. With `f64_clause` (Median
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
    # (tracker, patch, component) of each component beyond K5_MAX
    parting = [[i // (2 * got.shape[1]), i // 2 % got.shape[1], i % 2]
               for i in far.nonzero().flatten().tolist()]
    row = dict(n=n, iters=n_iters, window=win.shape[-1], err=err,
               layout=list(gf.layout(n, n_iters)), parting=parting,
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
             f"clause (tracker, patch, component: {parting})"
             if f64_clause else ""))
    _check(bool((~far | by_f64).all()) and row["n_over"] <= K5_OVER_SHARE
           * row["n_patches"], f"{name}: cuda vs plain disp max {err} "
           f"(limit {K5_MAX}" + (", or no further than the float32 plain "
           "form from the float64 one, plus the limit" if f64_clause
           else "") + f"), {row['n_over']} patches over {K5_TOL} "
           f"(limit {K5_OVER_SHARE} of {row['n_patches']})")
    row["ms"] = _graph_ms(torch, lambda: gf.grid_flow(*args))
    row["plain_ms"] = _time_ms(torch, lambda: gf.grid_flow_ref(*args), 5)
    (row["bound_ms"], row["bound_by"], row["bytes"],
     row["flops"]) = _k5_bound(torch, win, pts, want, scale, n, n_iters,
                               kind)
    print(f"{name} B={win.shape[0]} P={pts.shape[-1] // n} n={n} "
          f"iters={n_iters} window {win.shape[-1]} layout "
          f"{row['layout'][0]} lanes x {row['layout'][1]}: max|ddisp| "
          f"{err:.3g} "
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
            "n_over", "n_patches", "n_by_f64", "parting", "cuda_vs_f64",
            "plain_vs_f64", "worst", "max_disp", "n", "iters", "window",
            "layout")
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
            "n", "iters", "window", "layout")
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


def _steps_per_update(sm, frame_d, states):
    """Iterations one update takes until every tracker is done (the done
    masks' loop, `LKBase._step` calls)."""
    n = [0]
    step = type(sm)._step

    def counted(*a, **k):
        n[0] += 1
        return step(sm, *a, **k)
    sm._step = counted
    try:
        sm.update(states, frame_d)
    finally:
        del sm._step
    return n[0]


def _generic_phase(torch, tk, gf, card, dev, frame0, frame_d, frame3_d):
    """Slice 8: the generic fleets (`generic_family`) timed with their GT
    legs, entry()'s LM fleet also with the teacher-forced plain-path check
    (and PLAIN_PATH_FAULT on it, which must fail) and the iterations one
    update takes until every tracker is done; iclm on iclk's shapes with
    its GT leg; `__graft_entry__.entry()`'s configuration at its own
    shapes for one update; then 3 updates of every other option
    (`routing_family`), each on the path `_fused_ok` names."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    out = {}
    fam = dict(generic_family())
    key, am, ssm, b, cfg, gt_ssm = fam["iclk_ssd"]
    fam["iclm_ssd"] = ("iclm", am, ssm, b, cfg, gt_ssm)
    for name, (key, am, ssm, b, cfg, gt_ssm) in fam.items():
        crn = _corners(b)
        label = f"{name} ({key}/{am}/{ssm})"
        timed = name != "iclm_ssd"
        moving = cfg.get("epsilon", 0.0) > 0
        sm, fps, _ = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                            gf, {}, windows=GENERIC_WINDOWS if timed else 0,
                            cfg=cfg, label=label, ssm=ssm, moving=moving)
        row = {"B": b, "fps": fps,
               "update_ms": 1e3 * b / fps if fps else None}
        if moving:
            # the same updates without done masks (epsilon 0: no host sync
            # and no done test per iteration) in the same run
            _, fps0, _ = _fleet(torch, key, am, b, card, crn, frame_d, dev,
                                tk, gf, {}, windows=GENERIC_WINDOWS,
                                cfg=dict(cfg, epsilon=0.0), ssm=ssm,
                                label=f"{label} epsilon 0", moving=True)
            row["update_ms_epsilon0"] = 1e3 * b / fps0
            print(f"{label}: update {row['update_ms']:.2f} ms with done "
                  f"masks, {row['update_ms_epsilon0']:.2f} ms at epsilon 0 "
                  f"({card})")
        reading = GENERIC_GT_READING_PX[name]
        if name in GENERIC_GT_LOST:
            med, lost, gt, frames = _gt_leg_lost(
                sm, frame0, crn, GENERIC_GT_LOST[name], label, gt_ssm=gt_ssm)
            med_ref, lost_ref = GENERIC_GT_LOST[name]
            row.update(gt_median_px=med, gt_median_limit_px=gt_limit(med_ref),
                       lost=lost, lost_limit=lost_ref + int(np.ceil(
                           LOST_MARGIN * b)), gt_px=gt,
                       jax_cpu_reading_px=reading,
                       jax_cpu_median_px=med_ref, jax_cpu_lost=lost_ref)
        else:
            gt, frames = _gt_leg(sm, frame0, crn, gt_limit(reading), label,
                                 gt_ssm=gt_ssm)
            row.update(gt_px=gt, gt_limit_px=gt_limit(reading),
                       jax_cpu_reading_px=reading)
        if sm.prm.epsilon > 0:
            # the first update of the GT leg
            n_it = _steps_per_update(sm, frames[1],
                                     sm.initialize(frames[0], crn))
            row["iterations_until_all_done"] = n_it
            print(f"{label}: the GT leg's first update ran {n_it} of "
                  f"{sm.prm.max_iters} iterations until every tracker was "
                  "done")
        if sm.prm.enable_lm and name == "eslm_ncc_generic":
            row["plain_path_px"], row["lm_disagreements"], _ = \
                _plain_path_check(sm, key, am, frames, crn, label, cfg=cfg,
                                  ssm=ssm)
            _, _, ok = _plain_path_check(sm, key, am, frames, crn, label,
                                         cfg=cfg, ssm=ssm,
                                         planted=PLAIN_PATH_FAULT)
            row["planted_fault_rejected"] = not ok
        out[name] = row
        del sm, frames
        torch.cuda.empty_cache()

    # entry()'s configuration at its own shapes: 16x16 on 64x80 frames
    sm = create_tracker("eslm", "ncc", "8", resx=16, resy=16, max_iters=10,
                        device=dev)
    _zero_counts(tk, gf)
    st = sm.update(sm.initialize(_toy_frame(), np.array(
        [[[20, 16], [60, 16], [60, 48], [20, 48]]], np.float32)),
        _toy_frame(seed=1))
    c = sm.corners(st)
    _check(bool(torch.isfinite(c).all()), "entry(): corners not finite")
    _check(not any(_counts(tk, gf).values()), "entry(): a kernel launched")
    print(f"entry() configuration: one update, corners "
          f"{c[0].cpu().numpy().round(3).tolist()}")
    out["entry"] = {"B": 1, "corners": c[0].cpu().numpy().tolist()}

    # every other option: 3 updates each, on the path _fused_ok names
    crn = _corners(B_ROUTING)
    five = torch.cat([frame3_d, frame_d[..., None], frame_d[..., None]], -1)
    frames = {"gray": frame_d, "rgb": frame3_d, "five": five}
    for name, (key, am, ssm, cfg, frm, expect) in routing_family().items():
        _, _, got = _fleet(torch, key, am, B_ROUTING, card, crn,
                           frames[frm], dev, tk, gf, expect, windows=0,
                           cfg=cfg, label=f"{name} ({key}/{am}/{ssm})",
                           ssm=ssm)
        out[name] = {"B": B_ROUTING, "launches": got}
        torch.cuda.empty_cache()
    return out


def _profile_updates(torch, fleet, states, frame, n=PROFILED_UPDATES,
                     top=0, label=""):
    """`n` updates under `torch.profiler`: (device ms of all kernels per
    update, kernel launches per update, the states); with `top`, prints
    the `top` kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            states = fleet.update(states, frame)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if top:
        worst = sorted(kernels, key=lambda e: -e.self_device_time_total)
        print(f"{label}: top kernels by device ms per update: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms x "
            f"{e.count // n}" for e in worst[:top]))
    return device_ms, sum(e.count for e in kernels) / n, states


def _stochastic_phase(torch, tk, gf, card, dev, frame0, frame_d):
    """Slice 9: the pf500 and nn1k rows (`stochastic_family`) through the
    entry points at their bench_extra.py configurations: WARMUP updates
    and STOCH_WINDOWS timed windows of STEPS updates on the scene (as
    `bench_extra._fleet_fps`), no kernel of the port launched; then
    PROFILED_UPDATES updates under the profiler (device ms, busy share,
    kernel launches per update; every state tensor must be on the card);
    then the GT leg at each of GT_SEEDS, held by its median and the
    trackers it loses (`_gt_leg_lost`, STOCH_GT_LOST); then 3 updates of
    every other key and option (`stochastic_routing`) with their exact
    launch counts."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    out = {}
    for name, (key, am, ssm, b, cfg) in stochastic_family().items():
        crn = _corners(b)
        label = f"{name} ({key}/{am}/{ssm})"
        t0 = time.perf_counter()
        sm, fps, _ = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                            gf, {}, windows=STOCH_WINDOWS, cfg=cfg,
                            label=label, ssm=ssm)
        stage_s = {"timed": time.perf_counter() - t0}
        fleet = TrackerFleet(sm, donate=True)
        states = fleet.initialize(frame_d, crn)
        states = fleet.update(states, frame_d)
        dev_ms, launches, states = _profile_updates(torch, fleet, states,
                                                    frame_d)
        on_card = [x.is_cuda for x in torch.utils._pytree.tree_leaves(
            states) if isinstance(x, torch.Tensor) and x.dim() > 0]
        _check(all(on_card) and launches > 0,
               f"{label}: a state tensor off the card, or no launch")
        stage_s["profiled"] = time.perf_counter() - t0 - stage_s["timed"]
        update_ms = 1e3 * b / fps
        row = {"B": b, "fps": fps, "update_ms": update_ms,
               "device_ms_per_update": dev_ms,
               "busy_share": dev_ms / update_ms,
               "launches_per_update": launches}
        print(f"{label}: update {update_ms:.2f} ms, {fps:.1f} frames/s, "
              f"device {dev_ms:.2f} ms per update (busy share "
              f"{dev_ms / update_ms:.3f}), {launches:.0f} launches per "
              f"update ({card})")
        del fleet, states
        med_ref, lost_ref = STOCH_GT_LOST[name]
        row.update(gt_median_limit_px=gt_limit(med_ref),
                   lost_limit=lost_ref + int(np.ceil(LOST_MARGIN * b)),
                   jax_cpu_median_px=med_ref, jax_cpu_lost=lost_ref,
                   jax_cpu_mean_px=STOCH_GT_MEAN_PX[name], seeds={})
        for seed in GT_SEEDS:
            sm = create_tracker(key, am, ssm, device=dev,
                                **dict(cfg, seed=seed))
            med, lost, gt, _ = _gt_leg_lost(sm, frame0, crn,
                                            STOCH_GT_LOST[name],
                                            f"{label} seed {seed}")
            row["seeds"][seed] = {"gt_median_px": med, "lost": lost,
                                  "gt_px": gt}
        stage_s["gt_legs"] = (time.perf_counter() - t0 - stage_s["timed"]
                              - stage_s["profiled"])
        row["stage_s"] = stage_s
        print(f"{label}: stage seconds " + ", ".join(
            f"{k} {v:.1f}" for k, v in stage_s.items()))
        out[name] = row
        del sm
        torch.cuda.empty_cache()

    for name, (key, am, ssm, b, cfg, expect) in stochastic_routing().items():
        t0 = time.perf_counter()
        _, _, got = _fleet(torch, key, am, b, card, _corners(b), frame_d,
                           dev, tk, gf, expect, windows=0, cfg=cfg,
                           label=f"{name} ({key}/{am}/{ssm})", ssm=ssm)
        out[name] = {"B": b, "launches": got,
                     "wall_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    return out


def _slice10_phase(torch, tk, gf, card, dev, frame0, frame_d, frame3_d):
    """Slice 10: the fleets of `slice10_family` through the entry points,
    each with its exact launches per update: WARMUP updates and one timed
    window of STEPS updates on the scene, the init's seconds apart (LP's
    training, RegNet's), one update under the profiler for
    SLICE10_PROFILED (device ms, busy share, launches; every state tensor
    on the card); the GT leg, held by its mean (SLICE10_GT_READING_PX),
    its first frame's median (SLICE10_GT_FIRST_FRAME), or its median and
    the trackers lost (SLICE10_GT_LOST; lpfc and gtrn on their first
    trackers at each of GT_SEEDS, SLICE10_LEARNED_GT); the
    plain-path check of hesm, lpfc and line. Then 3 updates of every other
    key and option (`slice10_routing`), after checking that each full-grid
    AM raises under coarse phases."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    out = {}
    for name, (key, am, ssm, b, cfg, expect) in slice10_family().items():
        crn = _corners(b)
        label = f"{name} ({key}/{am}/{ssm})"
        t0 = time.perf_counter()
        timing = {}
        sm, fps, got = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                              gf, expect, windows=1, cfg=cfg, label=label,
                              ssm=ssm, timing=timing,
                              max_not_finite=not_finite_limit(
                                  SLICE10_NOT_FINITE.get(name, (0, 0))))
        update_ms = 1e3 * b / fps
        row = {"B": b, "fps": fps, "update_ms": update_ms,
               "init_s": timing["init_s"], "launches": got,
               "not_finite_after_updates": timing["not_finite"],
               "not_finite_limit": not_finite_limit(
                   SLICE10_NOT_FINITE.get(name, (0, 0)))}
        print(f"{label}: init {timing['init_s']:.2f} s, update "
              f"{update_ms:.2f} ms ({card})")
        if name in SLICE10_PROFILED:
            fleet = TrackerFleet(sm, donate=True)
            states = fleet.update(fleet.initialize(frame_d, crn), frame_d)
            dev_ms, launches, states = _profile_updates(torch, fleet, states,
                                                        frame_d, n=1)
            on_card = [x.is_cuda for x in torch.utils._pytree.tree_leaves(
                states) if isinstance(x, torch.Tensor) and x.dim() > 0]
            _check(all(on_card) and launches > 0,
                   f"{label}: a state tensor off the card, or no launch")
            row.update(device_ms_per_update=dev_ms,
                       busy_share=dev_ms / update_ms,
                       launches_per_update=launches)
            print(f"{label}: device {dev_ms:.2f} ms per update (busy share "
                  f"{dev_ms / update_ms:.3f}), {launches:.0f} launches per "
                  f"update ({card})")
            del fleet, states
        if name in SLICE10_LEARNED_GT:
            n_gt, meds, lost_ref, nf_ref = SLICE10_LEARNED_GT[name]
            sub = crn[:n_gt]
            limit = learned_limit(meds)
            row.update(gt_median_limit_px=limit,
                       lost_limit=lost_ref + int(np.ceil(
                           LOST_MARGIN * len(sub))),
                       jax_cpu_median_px=list(meds), jax_cpu_lost=lost_ref,
                       gt_trackers=len(sub), seeds={})
            for seed in GT_SEEDS:
                sm_s = create_tracker(key, am, ssm, device=dev,
                                      **dict(cfg, seed=seed))
                med, lost, gt, frames = _gt_leg_lost(
                    sm_s, frame0, sub, (max(meds), lost_ref, nf_ref),
                    f"{label} seed {seed}", limit=limit)
                row["seeds"][seed] = {"gt_median_px": med, "lost": lost,
                                      "gt_px": gt}
                if seed == GT_SEEDS[0] and key == "lpfc":
                    row["plain_path_px"] = _plain_path_check(
                        sm_s, key, am, frames, sub, label, cfg=cfg,
                        ssm=ssm)[0]
        elif name in SLICE10_GT_FIRST_FRAME:
            ref, nf_ref = SLICE10_GT_FIRST_FRAME[name]
            e, _ = _gt_errors(sm, frame0, crn)
            e, nf = _held_errors(e, nf_ref, label)
            med1 = float(np.median(e[:, 0]))
            lost = int((e.max(1) > LOST_PX).sum())
            print(f"{label} GT: frame-1 median corner error {med1:.4f} px, "
                  f"limit {gt_limit(ref):.4f} (the JAX package {ref}); "
                  f"median per frame {np.median(e, 0).round(4).tolist()}, "
                  f"{lost} of {b} trackers lost (the JAX package 1,023)")
            _check(med1 <= gt_limit(ref), f"{label} GT frame-1 median "
                   f"corner error {med1} px (limit {gt_limit(ref)})")
            row.update(gt_frame1_median_px=med1,
                       gt_frame1_limit_px=gt_limit(ref),
                       jax_cpu_frame1_median_px=ref, lost=lost,
                       gt_not_finite=nf, jax_cpu_gt_not_finite=nf_ref,
                       gt_median_px=float(np.median(e, 0).mean()))
        elif name in SLICE10_GT_LOST:
            med_ref, lost_ref = SLICE10_GT_LOST[name][:2]
            med, lost, gt, frames = _gt_leg_lost(sm, frame0, crn,
                                                 SLICE10_GT_LOST[name], label)
            row.update(gt_median_px=med, gt_median_limit_px=gt_limit(med_ref),
                       lost=lost, lost_limit=lost_ref + int(np.ceil(
                           LOST_MARGIN * b)), gt_px=gt,
                       jax_cpu_median_px=med_ref, jax_cpu_lost=lost_ref)
        else:
            reading = SLICE10_GT_READING_PX[name]
            gt, frames = _gt_leg(sm, frame0, crn, gt_limit(reading), label)
            row.update(gt_px=gt, gt_limit_px=gt_limit(reading),
                       jax_cpu_reading_px=reading)
        if key in ("hesm", "line"):
            row["plain_path_px"] = _plain_path_check(
                sm, key, am, frames, crn, label, cfg=cfg, ssm=ssm)[0]
        row["wall_s"] = time.perf_counter() - t0
        print(f"{label}: {timing['not_finite']} of {b} trackers not finite "
              f"after the timed updates (limit {row['not_finite_limit']}); "
              f"stage {row['wall_s']:.1f} s")
        out[name] = row
        del sm
        torch.cuda.empty_cache()

    crn = _corners(B_SLICE10_ROUTING)
    for am in FULL_GRID_AMS:
        sm = create_tracker("fclk", am, "8", device=dev, **slice_cfg())
        try:
            sm.initialize(frame_d, crn)
            raised = False
        except RuntimeError:
            raised = True
        _check(raised, f"fclk/{am}: no raise under coarse phases (its "
               "similarity needs the full grid, as in the JAX package)")
    print(f"{', '.join(FULL_GRID_AMS)} raise under coarse phases, as in the "
          "JAX package")
    frames = {"gray": frame_d, "rgb": frame3_d}
    for name, (key, am, ssm, cfg, frm, expect) in slice10_routing().items():
        t0 = time.perf_counter()
        _, _, got = _fleet(torch, key, am, B_SLICE10_ROUTING, card, crn,
                           frames[frm], dev, tk, gf, expect, windows=0,
                           cfg=cfg, label=f"{name} ({key}/{am}/{ssm})",
                           ssm=ssm)
        out[name] = {"B": B_SLICE10_ROUTING, "launches": got,
                     "wall_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    return out


# -- slice 12: the box trackers ---------------------------------------------
def _tld_scene():
    """`tests/test_tld.py`'s scene: smoothed noise, 160 x 200, 0-255."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(3)
    img = gaussian_filter(rng.standard_normal((160, 200)), 2.0)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def tld_occlusion_boxes():
    """`tests/test_tld.py`'s box and the B_SLICE12_ROUTING sub-pixel
    offsets of the occlusion leg's trackers (B, 1, 2)."""
    c0 = np.array([[60, 50], [110, 50], [110, 100], [60, 100]], np.float32)
    return c0, np.random.default_rng(5).uniform(
        -0.5, 0.5, (B_SLICE12_ROUTING, 1, 2)).astype(np.float32)


def tld_occlusion_frame(scene, t, dxdy, occ):
    """Frame t of the occlusion leg: the scene moved by dxdy, the target
    covered by noise from `occ` on the frames of TLD_OCC_HIDDEN."""
    dx, dy = dxdy
    f = np.roll(np.roll(scene, dy, axis=0), dx, axis=1)
    lo, hi = TLD_OCC_HIDDEN
    if lo <= t < hi:
        c = np.array([85.0, 75.0]) + [dx, dy]
        x0, y0 = int(c[0] - 35), int(c[1] - 35)
        h = min(70, 160 - max(0, y0))
        w = min(70, 200 - max(0, x0))
        f = f.copy()
        f[max(0, y0):max(0, y0) + h, max(0, x0):max(0, x0) + w] = \
            128.0 + 20 * occ.standard_normal((h, w))
    return f


def _tld_occlusion(torch, dev, card):
    """TLD's occlusion leg at B_SLICE12_ROUTING trackers: `tests/test_tld.py`'s
    box (each tracker's moved by a sub-pixel offset), trajectory and
    occluder (noise over the target on frames TLD_OCC_HIDDEN). Every
    tracker must go invalid on some hidden frame; as many as
    TLD_OCC_REACQUIRED holds must be valid again on some later frame,
    each of those ending within TLD_OCC_FINAL_PX of the target."""
    from mtf_tpu_torch import create_tracker
    scene = _tld_scene()
    c0, offs = tld_occlusion_boxes()
    target0 = np.array([85.0, 75.0]) + offs[:, 0]
    sm = create_tracker("tld", device=dev, **TLD_OCC_CFG)
    t0 = time.perf_counter()
    st = sm.initialize(scene, c0[None] + offs)
    occ = np.random.default_rng(9)
    valid, errs = [], []
    lo, hi = TLD_OCC_HIDDEN
    for t, d in enumerate(TLD_OCC_TRAJ):
        st = sm.update(st, tld_occlusion_frame(scene, t, d, occ))
        valid.append(st.valid.cpu().numpy())
        errs.append(np.linalg.norm(st.center.cpu().numpy()
                                   - (target0 + d), axis=1))
    valid, errs = np.stack(valid), np.stack(errs)
    went = ~valid[lo:hi].all(0)
    back = valid[hi:].any(0)
    ref, flips = TLD_OCC_REACQUIRED
    least = ref - int(np.ceil(3 * np.sqrt(flips)))
    near = errs[-1][back] < TLD_OCC_FINAL_PX
    print(f"tld occlusion leg B={B_SLICE12_ROUTING}: valid trackers per "
          f"frame {valid.sum(1).tolist()} (hidden on frames {lo}-{hi - 1}); "
          f"{int(went.sum())} went invalid while hidden, {int(back.sum())} "
          f"re-acquired (at least {least}; the JAX package {ref}), their "
          f"final error max {float(errs[-1][back].max(initial=0.0)):.3f} px "
          f"(limit {TLD_OCC_FINAL_PX}) ({card})")
    _check(went.all() and back.sum() >= least and near.all(),
           f"tld occlusion leg: invalid while hidden {went.tolist()}, "
           f"re-acquired {back.tolist()}, final errors "
           f"{errs[-1].round(3).tolist()}")
    return {"B": B_SLICE12_ROUTING, "valid_per_frame": valid.sum(1).tolist(),
            "reacquired": int(back.sum()), "reacquired_least": least,
            "jax_cpu_reacquired": ref,
            "final_err_px_max": float(errs[-1][back].max(initial=0.0)),
            "wall_s": time.perf_counter() - t0}


def _slice12_phase(torch, tk, gf, card, dev, frame0, frame_d):
    """Slice 12: the fleets of `slice12_family` through the entry points,
    each with its exact launches per update: WARMUP updates and one timed
    window of STEPS updates on the scene by the host clock, one update
    under the profiler (device ms, busy share, launches; every state
    tensor on the card), the GT leg on the homography's sequence
    (SLICE12_GT_READING_PX, or SLICE12_GT_LOST by the median and the
    trackers lost); then 3 updates of every other option
    (`slice12_routing`) and TLD's occlusion leg (`_tld_occlusion`)."""
    from mtf_tpu_torch.parallel import TrackerFleet
    out = {}
    for name, (key, am, ssm, b, cfg, expect) in slice12_family().items():
        crn = _corners(b)
        label = f"{name} ({key})"
        t0 = time.perf_counter()
        timing = {}
        sm, fps, got = _fleet(torch, key, am, b, card, crn, frame_d, dev, tk,
                              gf, expect, windows=1, cfg=cfg, label=label,
                              ssm=ssm, timing=timing)
        update_ms = 1e3 * b / fps
        fleet = TrackerFleet(sm, donate=True)
        states = fleet.update(fleet.initialize(frame_d, crn), frame_d)
        dev_ms, launches, states = _profile_updates(torch, fleet, states,
                                                    frame_d, n=1, top=3,
                                                    label=label)
        on_card = [x.is_cuda for x in torch.utils._pytree.tree_leaves(
            states) if isinstance(x, torch.Tensor) and x.dim() > 0]
        _check(all(on_card) and launches > 0,
               f"{label}: a state tensor off the card, or no launch")
        del fleet, states
        row = {"B": b, "fps": fps, "update_ms": update_ms,
               "init_s": timing["init_s"], "launches": got,
               "device_ms_per_update": dev_ms,
               "busy_share": dev_ms / update_ms,
               "launches_per_update": launches}
        print(f"{label}: init {timing['init_s']:.2f} s, update "
              f"{update_ms:.2f} ms, {fps:.1f} frames/s, device {dev_ms:.2f} "
              f"ms per update (busy share {dev_ms / update_ms:.3f}), "
              f"{launches:.0f} launches per update ({card})")
        if name in SLICE12_GT_LOST:
            med_ref, lost_ref = SLICE12_GT_LOST[name][:2]
            med, lost, gt, _ = _gt_leg_lost(sm, frame0, crn,
                                            SLICE12_GT_LOST[name], label,
                                            gt_ssm=SLICE12_GT_SSM)
            row.update(gt_median_px=med, gt_median_limit_px=gt_limit(med_ref),
                       lost=lost, lost_limit=lost_ref + int(np.ceil(
                           LOST_MARGIN * b)), gt_px=gt,
                       jax_cpu_median_px=med_ref, jax_cpu_lost=lost_ref)
        else:
            reading = SLICE12_GT_READING_PX[name]
            gt, _ = _gt_leg(sm, frame0, crn, gt_limit(reading), label,
                            gt_ssm=SLICE12_GT_SSM)
            row.update(gt_px=gt, gt_limit_px=gt_limit(reading),
                       jax_cpu_reading_px=reading)
        row["wall_s"] = time.perf_counter() - t0
        print(f"{label}: stage {row['wall_s']:.1f} s")
        out[name] = row
        del sm
        torch.cuda.empty_cache()

    crn = _corners(B_SLICE12_ROUTING)
    for name, (key, am, ssm, cfg, expect) in slice12_routing().items():
        t0 = time.perf_counter()
        _, _, got = _fleet(torch, key, am, B_SLICE12_ROUTING, card, crn,
                           frame_d, dev, tk, gf, expect, windows=0, cfg=cfg,
                           label=f"{name} ({key})", ssm=ssm)
        out[name] = {"B": B_SLICE12_ROUTING, "launches": got,
                     "wall_s": time.perf_counter() - t0}
    out["tld_occlusion"] = _tld_occlusion(torch, dev, card)
    torch.cuda.empty_cache()
    return out


# -- slice 13: the user entry points ---------------------------------------
SLICE13_FRAMES = 60      # the recorded sequence: 480x640 8-bit PNGs
SLICE13_SIGMA = 0.008    # the random walk's step (synthetic_sequence)
SLICE13_SEED = 13
SLICE13_BOX = ((270.0, 190.0), (370.0, 190.0), (370.0, 290.0),
               (270.0, 290.0))
SLICE13_FLEET_OBJS = 16  # run_mtf --n_objs: the fleet protocol
SLICE13_FLEET_FRAMES = 6
SLICE13_FLEET_TOL_PX = 1e-4   # fleet against single-object runs
SLICE13_API_FRAMES = 10  # frames the APIs track
SLICE13_API_TOL_PX = 1e-4     # the APIs' corners against run_mtf's
SLICE13_CKPT_AT = 5      # fleet updates before the checkpoint
SLICE13_BUDGET_S = 60.0
# eval_suite's frames: each configuration's first 7 updates of its 20-frame
# sequence (the same frames: a shorter draw of one seed is its prefix), its
# budget held on their worst error (the fclm legs run 1.3-1.4 s an update)
SLICE13_SUITE_FRAMES = 8
SLICE13_FLEET_SIGMA = "0.005"  # run_mtf's syn_sigma: 40x30-px regions
# the three protocols, then the failure path forced (a threshold under the
# tracking noise: every object fails, skips 2 frames and is re-initialised
# into its fleet rows)
SLICE13_PROTOCOLS = ("--reinit_on_failure", "--reinit_at_each_frame",
                     "--reset_at_each_frame",
                     "--reinit_on_failure --reinit_err_thresh 1e-6 "
                     "--reinit_frame_skip 2")
# the JAX package's run_mtf on the CPU over the same sequence, its PNGs
# rendered on the CPU (`scripts/port_slice13_reference_leg.py`; the card
# renders its own, `slice13_sequence`): (avg_mcd px, failures)
SLICE13_JAX_READING = {"fclk_ssd": (0.05262000315775305, 0),
                       "esm_ncc": (0.0378742128989454, 0),
                       "rklt_ssd": (0.051280725684206364, 0)}


def slice13_pairs(key: str) -> list:
    """The bench configuration as run_mtf's CLI pairs
    (`scripts/real_protocol.py:110-127`): `slice_cfg()`, and for rklt
    `rklt_cfg()`."""
    crop = CROP_RKLT if key == "rklt" else CROP
    pairs = ["resx", str(RES), "resy", str(RES), "max_iters", str(MAX_ITERS),
             "epsilon", "0", "interp", "linear_mm", "crop", str(crop),
             "coarse_pt_iters", ",".join(f"{s}:{n}" for s, n in SCHEDULE)]
    if key == "rklt":
        pairs += ["grid_sub_iters", "1,8", "grid_coarse_stride", "2"]
    return pairs


def slice13_legs():
    """run_mtf's legs on the recorded sequence: {name: (CLI pairs,
    launches per update by kernel)}."""
    return {
        "fclk_ssd": (["sm", "fclk", "am", "ssd", "ssm", "8"]
                     + slice13_pairs("fclk"), {"ssd": MAX_ITERS}),
        "esm_ncc": (["sm", "esm", "am", "ncc", "ssm", "8"]
                    + slice13_pairs("esm"), {"ncc_esm": MAX_ITERS}),
        "rklt_ssd": (["sm", "rklt", "am", "ssd", "ssm", "8"]
                     + slice13_pairs("rklt"),
                     {"ssd_esm": MAX_ITERS,
                      "grid_flow@linear": K5_PER_UPDATE}),
    }


def slice13_sequence(root: str, device):
    """Record the slice-13 sequence under `root`: `seq13/frame%05d.png`
    (8-bit gray, lossless) and its MTF GT file `seq13.txt`, rendered by
    the port's `synthetic_sequence` on `device` (the scene, SLICE13_BOX
    moving by the homography's random walk, SLICE13_SEED). -> (sequence
    directory, GT path, GT (T, 4, 2))."""
    import os

    import cv2
    import torch
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import gt as gtio
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    frames, gt = synthetic_sequence(
        _scene(0), np.asarray(SLICE13_BOX, np.float32),
        get_ssm("8", device=device), n_frames=SLICE13_FRAMES,
        sigma_scale=SLICE13_SIGMA, seed=SLICE13_SEED)
    u8 = torch.clamp(torch.round(frames), 0, 255).to(torch.uint8)
    seq = os.path.join(root, "seq13")
    os.makedirs(seq, exist_ok=True)
    names = [f"frame{t + 1:05d}.png" for t in range(len(u8))]
    for name, f in zip(names, u8.cpu().numpy()):
        _check(cv2.imwrite(os.path.join(seq, name), f), f"cannot write {name}")
    gt_path = os.path.join(root, "seq13.txt")
    gtio.write_corners_file(gt_path, gt, names)
    return seq, gt_path, np.asarray(gt, np.float32)


def _on_card(torch, state) -> bool:
    return all(x.is_cuda for x in torch.utils._pytree.tree_leaves(state)
               if isinstance(x, torch.Tensor) and x.dim() > 0)


def _slice13_leg(torch, tk, gf, name, pairs, expect, seq, gt_path, tmp):
    """One run_mtf leg on the recorded sequence, in-process, with
    `--write_outputs --reinit_on_failure`: its exact launches per update,
    its avg_mcd and failures against the JAX reading, its artifacts read
    back through the port's `utils.gt`, its state on the card."""
    import os

    from mtf_tpu_torch.apps import run_mtf
    from mtf_tpu_torch.utils import gt as gtio
    out_dir = os.path.join(tmp, f"log_{name}")
    _zero_counts(tk, gf)
    fps, avg = run_mtf.main(["--seq", seq, "--gt", gt_path, "--write_outputs",
                             "--reinit_on_failure", "--out_dir", out_dir]
                            + pairs)
    counts = _counts(tk, gf)
    MAIN_PATH_LAUNCHES.update(counts)
    run = dict(run_mtf.LAST_RUN)
    n_up = run["updates"]
    for k, got in counts.items():
        want = expect.get(k, 0)
        _check(got == want * n_up, f"run_mtf {name}: {k} launched {got} "
               f"times in {n_up} updates (expected {want} per update)")
    jax_avg, jax_fail = SLICE13_JAX_READING[name]
    limit = gt_limit(jax_avg)
    _check(np.isfinite(avg) and avg <= limit,
           f"run_mtf {name}: avg_mcd {avg} px (limit {limit}, JAX {jax_avg})")
    _check(run["failures"] == jax_fail, f"run_mtf {name}: {run['failures']} "
           f"failures (JAX {jax_fail})")
    sm, am, ssm = pairs[1], pairs[3], pairs[5]
    base = os.path.join(out_dir, f"seq13_{sm}_{am}_{ssm}")
    tracked = gtio.read_corners_file(base + ".txt")
    errs = gtio.read_errors_file(base + ".err")
    th, sr = gtio.read_sr_file(base + ".sr")
    stats = gtio.read_tracking_stats(os.path.join(out_dir,
                                                  "tracking_stats.txt"))
    _check(tracked.shape == run["tracked"].shape
           and np.abs(tracked - run["tracked"]).max() <= 1e-3
           and len(errs) == SLICE13_FRAMES - 1
           and np.allclose(errs, run["errors"], atol=1e-5, equal_nan=True)
           and len(th) == len(sr) == 100 and stats[-1] == run["summary"],
           f"run_mtf {name}: an artifact does not read back")
    _check(_on_card(torch, run["state"]), f"run_mtf {name}: a state "
           "tensor off the card")
    row = {"fps": fps, "update_ms": 1e3 / fps, "avg_mcd": avg,
           "failures": run["failures"], "updates": n_up,
           "launches": {k: counts[k] for k in expect},
           "jax_cpu_avg_mcd": jax_avg, "jax_cpu_failures": jax_fail,
           "limit_px": limit}
    print(f"run_mtf {name}: {run['summary']}; {n_up} updates, launches "
          + ", ".join(f"{k} {counts[k]}" for k in expect)
          + f"; JAX avg_mcd {jax_avg} failures {jax_fail}, limit {limit}")
    return row, run


def _slice13_fleet(torch, dev):
    """run_mtf --synthetic --n_objs 16 under each protocol, against 16
    single-object protocol runs (`run_mtf.run_single`) on the same frames:
    per-object errors within SLICE13_FLEET_TOL_PX (the JAX package's own
    claim, `tests/test_fleet_protocol.py:30`)."""
    import contextlib
    import io

    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.apps import run_mtf
    from mtf_tpu_torch.utils.config import read_params
    pairs = (["sm", "fclk", "am", "ssd", "ssm", "8"] + slice13_pairs("fclk")
             + ["syn_sigma", SLICE13_FLEET_SIGMA])
    out = {}
    for proto in SLICE13_PROTOCOLS:
        argv = ["--synthetic", "--n_objs", str(SLICE13_FLEET_OBJS),
                "--n_frames", str(SLICE13_FLEET_FRAMES)] + proto.split() \
            + pairs
        fps, _ = run_mtf.main(argv)
        fleet = dict(run_mtf.LAST_RUN)
        args, extra = run_mtf.build_argparser().parse_known_args(argv)
        cfg = read_params(None, extra)
        keys = tuple(str(cfg.pop(k)) for k in ("sm", "am", "ssm"))
        tracker = create_tracker(*keys, device=dev, **cfg)
        frames, gt = run_mtf.synthetic_input(
            SLICE13_FLEET_OBJS, SLICE13_FLEET_FRAMES, cfg, keys[2], dev)
        frames = [frames[i] for i in range(len(frames))]
        worst = 0.0
        for i in range(SLICE13_FLEET_OBJS):
            with contextlib.redirect_stdout(io.StringIO()):
                run_mtf.run_single(args, tracker, frames, gt[:, i], gt[0, i],
                                   "synthetic", keys)
            single = run_mtf.LAST_RUN["errors"]
            fe = fleet["errors"][:, i]
            _check(np.array_equal(np.isnan(single), np.isnan(fe)),
                   f"fleet {proto}: object {i}'s skipped frames differ")
            ok = ~np.isnan(fe)
            worst = max(worst, float(np.abs(single[ok] - fe[ok]).max(
                initial=0.0)))
        fails = int(np.isnan(fleet["errors"]).sum())
        _check(worst <= SLICE13_FLEET_TOL_PX, f"fleet {proto}: per-object "
               f"errors {worst} px from the single runs (limit "
               f"{SLICE13_FLEET_TOL_PX})")
        _check(("1e-6" in proto) == (fleet["failures"] > 0),
               f"fleet {proto}: {fleet['failures']} failures")
        print(f"run_mtf fleet {proto}: {fleet['summary']}; against "
              f"{SLICE13_FLEET_OBJS} single runs {worst:.3g} px")
        name = "forced_failures" if "1e-6" in proto else proto.lstrip("-")
        avg = fleet["avg_err"]
        out[name] = {"obj_fps": fps,
                     "avg_mcd": avg if np.isfinite(avg) else None,
                     "failures": fleet["failures"], "skipped": fails,
                     "vs_single_px": worst}
    return out


def _slice13_apis(torch, seq, gt, tracked):
    """pyMTF, pyMTF2 and one mex round trip on the recorded sequence, each
    against run_mtf's fclk/ssd corners on the same frames."""
    from mtf_tpu_torch import api, api2, api_mex
    from mtf_tpu_torch.utils.input import get_input
    cfg = slice_cfg()
    keys = dict(sm="fclk", am="ssd", ssm="8")
    frames = [f for _, f in zip(range(SLICE13_API_FRAMES + 1),
                                get_input(seq))]
    c0 = gt[0].T                                              # (2, 4)
    worst = {}

    def held(label, got, t):
        e = float(np.abs(np.asarray(got).T - tracked[t - 1]).max())
        worst[label] = max(worst.get(label, 0.0), e)

    tid = api.create(frames[0], c0, **keys, **cfg)
    for t in range(1, SLICE13_API_FRAMES + 1):
        held("api", api.getRegion(frames[t], tid), t)
    api.setRegion(gt[SLICE13_API_FRAMES].T, tid)
    _check(np.isfinite(api.getRegion(frames[-1], tid)).all(),
           "api: corners not finite after setRegion")
    api.remove(tid)
    _check(tid not in api.getTrackerIds(), "api: remove left the tracker")

    _check(api2.init(seq), "api2: init read no frame")
    reader = api2.reader()
    ids = api2.createTrackers([c0, c0], **keys, **cfg)
    for t in range(1, SLICE13_API_FRAMES + 1):
        _check(api2.step(), f"api2: no frame {t}")
        for k in ids:
            held("api2", api2.getRegion(k), t)
    api2.quit()

    ok, = api_mex.mex("init", seq)
    ok2, mid = api_mex.mex("create_tracker", c0, *[
        x for k, v in {**keys, **cfg}.items() for x in (k, v)])
    ok3, got = api_mex.mex("get_region", mid)
    held("mex", got, 1)
    ok4, = api_mex.mex("quit")
    _check(ok and ok2 and ok3 and ok4, "mex: a command failed")
    _check(max(worst.values()) <= SLICE13_API_TOL_PX, f"APIs against "
           f"run_mtf: {worst} px (limit {SLICE13_API_TOL_PX})")
    print(f"APIs against run_mtf's fclk/ssd corners: {worst} px; api2's "
          f"reader: {reader}")
    return {"vs_run_mtf_px": worst, "api2_reader": reader}


def _slice13_checkpoint_profile(torch, dev, seq, tmp):
    """Checkpoint a fleet mid-sequence and resume it (the next update
    equal to the uninterrupted one, every leaf); then `Profiler.section`
    with `sync` and `trace` around one update each."""
    import os

    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.utils import checkpoint, profiling
    from mtf_tpu_torch.utils.input import get_input
    frames = [torch.as_tensor(f, device=dev) for _, f in
              zip(range(SLICE13_CKPT_AT + 3), get_input(seq))]
    crn = _corners(16)
    fleet = TrackerFleet(create_tracker("fclk", "ssd", "8", device=dev,
                                        **slice_cfg()))
    states = fleet.initialize(frames[0], crn)
    for t in range(1, SLICE13_CKPT_AT + 1):
        states = fleet.update(states, frames[t])
    path = os.path.join(tmp, "ckpt", "fleet.npz")
    checkpoint.save_fleet(path, states)
    resumed = checkpoint.load_fleet(path, fleet.initialize(frames[0], crn))
    nxt = SLICE13_CKPT_AT + 1
    a = torch.utils._pytree.tree_leaves(fleet.update(states, frames[nxt]))
    b = torch.utils._pytree.tree_leaves(fleet.update(resumed, frames[nxt]))
    exact = len(a) == len(b) and all(
        (x is None and y is None) or (x.device == y.device and
                                      torch.equal(x, y))
        for x, y in zip(a, b))
    _check(exact, "checkpoint: the resumed update differs")
    prof = profiling.Profiler()
    with prof.section("fleet_update", sync=states):
        states = fleet.update(states, frames[nxt])
    times = prof.write(os.path.join(tmp, "log", "times.txt"))
    with open(times) as f:
        _check(f.read().startswith("fleet_update n=1 "),
               "profiling: no fleet_update line")
    with profiling.trace(os.path.join(tmp, "trace")) as trace_dir:
        states = fleet.update(states, frames[nxt + 1])
        torch.cuda.synchronize()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = f.read()
    kernels = trace.count('"cat": "kernel"')
    _check("lk_fused_chain" in trace and kernels > 0,
           "profiling: the trace holds no chain-kernel launch")
    print(f"checkpoint: resumed update equal; Profiler section "
          f"{prof.summary()['fleet_update']['mean_ms']:.3f} ms; trace "
          f"{len(trace)} B, {kernels} kernel events")
    return {"resumed_exact": exact, "trace_kernel_events": kernels,
            "section_ms": prof.summary()["fleet_update"]["mean_ms"]}


def _slice13_phase(torch, tk, gf, card, dev):
    """Slice 13: the user entry points on the card. Record the sequence;
    run_mtf's three legs (fclk/ssd K1, esm/ncc K2 + K3, rklt/ssd K5 + K3)
    in-process with `--write_outputs --reinit_on_failure`; the fleet
    protocol against single runs; the APIs; a checkpoint and the
    profiler; the port's eval_suite at SLICE13_SUITE_FRAMES frames. Each
    check fails the run. Each stage's seconds are kept; SLICE13_BUDGET_S
    is the aim of the stages before eval_suite, whose generic MI and CCRE
    legs alone take longer (`PERF.md` §5)."""
    import tempfile

    from mtf_tpu_torch.apps import eval_suite
    t0 = time.perf_counter()
    out, stages = {}, {}

    def lap(name, t_prev):
        now = time.perf_counter()
        stages[name] = now - t_prev
        return now

    with tempfile.TemporaryDirectory() as tmp:
        seq, gt_path, gt = slice13_sequence(tmp, dev)
        t = lap("record", t0)
        tracked = None
        for name, (pairs, expect) in slice13_legs().items():
            out[name], run = _slice13_leg(torch, tk, gf, name, pairs, expect,
                                          seq, gt_path, tmp)
            if name == "fclk_ssd":
                tracked = run["tracked"]
        t = lap("run_mtf_legs", t)
        _check(out["fclk_ssd"]["failures"] == 0, "run_mtf fclk_ssd failed "
               "on the sequence, so the APIs have no corners to meet")
        out["fleet"] = _slice13_fleet(torch, dev)
        t = lap("fleet_protocol", t)
        out["apis"] = _slice13_apis(torch, seq, gt, tracked)
        t = lap("apis", t)
        out["checkpoint"] = _slice13_checkpoint_profile(torch, dev, seq, tmp)
        t = lap("checkpoint_profile", t)
    rc = eval_suite.main(["--n_frames", str(SLICE13_SUITE_FRAMES)])
    lap("eval_suite", t)
    _check(rc == 0, "eval_suite: a configuration missed its budget")
    out["stages_s"] = stages
    out["phase_s"] = time.perf_counter() - t0
    before_suite = out["phase_s"] - stages["eval_suite"]
    print(f"slice-13 stages: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in stages.items())
          + f"; {before_suite:.1f} s before eval_suite (aim "
          f"{SLICE13_BUDGET_S} s) ({card})")
    return out


# -- slice 14: the cv2 trackers, diagnostics, the bridge, the other apps --
B_SLICE14 = 16           # feat and cmt trackers on the blob scene
SLICE14_BLOBS = 1200     # `tests/test_feature.py`'s density at 480x640
SLICE14_HALF = (80, 60)  # the boxes' half width and height (px)
# the blob scene's descriptors are ambiguous: at the default 128 RANSAC
# hypotheses (4-point samples) a third of the trackers jump tens of px in
# both packages within 5 updates; 4096 keep every tracker of the leg
SLICE14_FEAT_CFG = dict(feat_n_hypotheses=4096)
SLICE14_TOL_PX = 0.05    # a device stage on the card against the CPU's
SLICE14_NODE_TOL_PX = 1e-4  # tracker_node against the in-process tracker
SLICE14_NODE_FRAMES = 6
SLICE14_BUDGET_S = 90.0
# x0, y0, w, h of the marker: the feature tracker draws its 128 minimal
# samples over all 500 keypoint slots, matched or not (as the JAX package
# does), so a marker whose matches fill few slots loses the homography in
# some updates; at this size every draw of 6 kept it (0.52-0.61 px)
SLICE14_MARKER_BOX = (100, 80, 440, 320)
SLICE14_UAV_SHAPE = (160, 200)              # UAV frames (h, w)
SLICE14_UAV_OFFSETS = ((150, 200), (156, 208), (163, 215), (169, 224))
SLICE14_UAV_PAIRS = ["resx", "50", "resy", "50", "max_iters", "10", "epsilon",
                     "0", "interp", "linear_mm", "crop", "160",
                     "coarse_pt_iters", "4:6,2:3"]
# create_mosaic's region is the frame but 15% margins: the bench
# configuration without a crop (the chain kernel reads the whole frame)
SLICE14_MOSAIC_PAIRS = ["resx", "50", "resy", "50", "max_iters", "10",
                        "epsilon", "0", "interp", "linear_mm",
                        "coarse_pt_iters", "4:6,2:3"]
SLICE14_GEN_FRAMES = 8   # generate_synthetic_seq on the card
# the JAX package's readings on the CPU of the same legs
# (`scripts/port_slice14_reference_leg.py`): the feat and cmt GT legs'
# mean corner error (px), parity_cv2's rows at their defaults (avg_mcd
# px), track_markers' and track_uav_trajectory's mean corner error against
# GT (px; the JAX apps with `_locate`'s call mended: reference fault 16),
# and the examples' mean errors (px)
SLICE14_JAX_READING = {
    "feat_gt_px": 0.4191060637123883, "cmt_gt_px": 0.903028667345643,
    "parity": {"opencv:ECC-homography": 0.0822, "mtf_tpu:esm/ncc/8": 0.0494,
               "mtf_tpu:fclk/ssd/8": 0.0464, "opencv:pyrLK+RANSAC": 0.0795,
               "mtf_tpu:rklt/ncc/8": 0.0477},
    "track_markers_px": 0.5159232619959093, "track_uav_px": 0.0,
    "simple_demo_px": 0.061, "composite_demo_px": {
        "pyr(esm/ncc/8)": 0.052, "casc(pf->fclk)": 0.053,
        "prl(esm|fclk)": 0.056}}
SLICE14_NODE_SCRIPT = (
    "import json, sys\n"
    "from mtf_tpu_torch.apps import tracker_node\n"
    "from mtf_tpu_torch.ops.kernels import lk_fused as tk\n"
    "from mtf_tpu_torch.ops.kernels import grid_flow as gf\n"
    "n = tracker_node.main(sys.argv[1:])\n"
    "counts = {**tk.lk_fused_chain_raw.launches, **tk.lk_fused_gn_t.launches,"
    " **{'grid_flow@' + k: v for k, v in gf.grid_flow.launches.items()}}\n"
    "print(json.dumps({'updates': n, 'launches': counts}))\n")


def blob_scene(h=480, w=640, n_blobs=SLICE14_BLOBS, seed=0):
    """`tests/test_feature.py`'s blob scene at any size: 5x5 squares of
    random gray, blurred (the feature trackers' textured scene)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        x, y = rng.integers(5, w - 5), rng.integers(5, h - 5)
        img[y - 2:y + 3, x - 2:x + 3] = rng.uniform(50, 255)
    return gaussian_filter(img, 1.0).astype(np.float32)


def slice14_corners(n=B_SLICE14, seed=1):
    """n boxes of half size SLICE14_HALF inside the 480x640 scene, 40 px
    from its edges (the feature trackers' regions)."""
    hw, hh = SLICE14_HALF
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(40 + hw, 600 - hw), rng.uniform(40 + hh, 440 - hh)
        out.append([[cx - hw, cy - hh], [cx + hw, cy - hh],
                    [cx + hw, cy + hh], [cx - hw, cy + hh]])
    return np.asarray(out, np.float32)


def slice14_gt_errors(sm, device):
    """The GT leg of a slice-14 fleet: `_gt_errors` on the blob scene
    with `slice14_corners()` along the homography's random walk -> (each
    tracker's mean corner error per frame (B, 5), the frames)."""
    return _gt_errors(sm, blob_scene(), slice14_corners(), gt_ssm="8")


def _write_seq(root, name, frames):
    import os

    import cv2
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for t, f in enumerate(frames):
        _check(cv2.imwrite(os.path.join(d, f"frame{t + 1:05d}.png"),
                           np.clip(np.rint(f), 0, 255).astype(np.uint8)),
               f"cannot write {name} frame {t}")
    return d


def slice14_marker_inputs(root, device):
    """track_markers' inputs under `root`: the blob scene (seed 2) along
    the homography's random walk (6 frames, the port's synth on `device`)
    as PNGs, and the marker, the SLICE14_MARKER_BOX crop of the first
    frame. -> (sequence dir, marker path, GT corners (T, 4, 2) of the
    marker's corners [0, w-1] x [0, h-1])."""
    import os

    import cv2
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    x0, y0, w, h = SLICE14_MARKER_BOX
    box = np.float32([[x0, y0], [x0 + w - 1, y0], [x0 + w - 1, y0 + h - 1],
                      [x0, y0 + h - 1]])
    frames, gt = synthetic_sequence(blob_scene(seed=2), box,
                                    get_ssm("8", device=device), n_frames=6,
                                    sigma_scale=0.004, seed=3)
    frames = frames.cpu().numpy()
    seq = _write_seq(root, "markerseq", frames)
    marker = os.path.join(root, "marker.png")
    _check(cv2.imwrite(marker, np.clip(np.rint(frames[0][y0:y0 + h,
                                                         x0:x0 + w]),
                                       0, 255).astype(np.uint8)),
           "cannot write the marker")
    return seq, marker, np.asarray(gt, np.float32)


def slice14_uav_inputs(root):
    """track_uav_trajectory's inputs under `root`: the map (the blob
    scene, seed 5) and the UAV frames, SLICE14_UAV_SHAPE windows of it at
    SLICE14_UAV_OFFSETS (y, x). -> (map path, sequence dir, GT corners
    (T, 4, 2) of each frame's template region in the map)."""
    import os

    import cv2
    scene = blob_scene(seed=5)
    path = os.path.join(root, "map.png")
    _check(cv2.imwrite(path, np.rint(scene).astype(np.uint8)),
           "cannot write the map")
    fh, fw = SLICE14_UAV_SHAPE
    seq = _write_seq(root, "uavseq", [scene[oy:oy + fh, ox:ox + fw]
                                      for oy, ox in SLICE14_UAV_OFFSETS])
    m = 0.2
    tmpl = np.float32([[fw * m, fh * m], [fw * (1 - m), fh * m],
                       [fw * (1 - m), fh * (1 - m)], [fw * m, fh * (1 - m)]])
    gt = np.stack([tmpl + np.float32([ox, oy])
                   for oy, ox in SLICE14_UAV_OFFSETS])
    return path, seq, gt


def corner_error(tracked, gt) -> float:
    """Mean corner distance (px) of corners (T, 4, 2) against GT."""
    return float(np.linalg.norm(np.asarray(tracked, np.float64) - gt,
                                axis=-1).mean())


def _state_on(torch, state, device):
    return torch.utils._pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, state)


def _slice14_stage_vs_cpu(torch, sm, cpu_sm, state, frame, label):
    """The device stage on the card against the same stage on the CPU:
    one frame's host detections, one draw, one state."""
    if label == "feat":
        pts, desc, valid = sm.detect_batch(frame, sm.corners(state)
                                           .transpose(-1, -2))
        idx = sm.hyp_draw(0)
        card = sm.update_with_detections(state, pts, desc, valid, idx=idx)
        cpu = cpu_sm.update_with_detections(
            _state_on(torch, state, "cpu"), pts.cpu(), desc.cpu(),
            valid.cpu(), idx=idx.cpu())
    else:
        from mtf_tpu_torch.sm.cmt import _pad
        p = sm.prm
        gray = sm._gray(frame)
        pts, desc = sm._detect(gray)
        n = p.max_keypoints + p.max_bg
        args = [torch.as_tensor(a) for a in (
            _pad(pts, n, 2)[0], _pad(desc, n, state.kp_desc.shape[-1])[0],
            _pad(pts, n, 2)[1])]
        card = sm.update_with_detections(state, *[a.to(gray.device)
                                                  for a in args], gray)
        cpu = cpu_sm.update_with_detections(_state_on(torch, state, "cpu"),
                                            *args, gray.cpu())
    err = float((sm.corners(card).cpu() - cpu_sm.corners(cpu)).abs().max())
    _check(err <= SLICE14_TOL_PX, f"{label}: the card's device stage "
           f"{err} px from the CPU's (limit {SLICE14_TOL_PX})")
    return err


def _slice14_trackers(torch, tk, gf, card, dev):
    """feat/ssd/8 (ORB) and cmt at B_SLICE14 on the blob scene: each GT
    leg against the JAX reading, no kernel launched, and the device stage
    on the card against the CPU's."""
    from mtf_tpu_torch import create_tracker
    out = {}
    for key in ("feat", "cmt"):
        cfg = SLICE14_FEAT_CFG if key == "feat" else {}
        sm = create_tracker(key, "ssd", "8", device=dev, **cfg)
        cpu_sm = create_tracker(key, "ssd", "8", device="cpu", **cfg)
        _zero_counts(tk, gf)
        t0 = time.perf_counter()
        e, frames = slice14_gt_errors(sm, dev)
        torch.cuda.synchronize()
        leg_s = time.perf_counter() - t0
        counts = _counts(tk, gf)
        _check(not any(counts.values()), f"{key}: kernels launched "
               f"{ {k: v for k, v in counts.items() if v} }")
        gt_px = float(e.mean())
        reading = SLICE14_JAX_READING[f"{key}_gt_px"]
        _check(np.isfinite(gt_px) and gt_px <= gt_limit(reading),
               f"{key}: GT mean corner error {gt_px} px (limit "
               f"{gt_limit(reading)}, JAX {reading})")
        st = sm.initialize(frames[0], slice14_corners())
        stage = _slice14_stage_vs_cpu(torch, sm, cpu_sm, st, frames[1], key)
        print(f"{key} B={B_SLICE14}: GT {gt_px:.4f} px over 5 frames (JAX "
              f"{reading}, limit {gt_limit(reading)}), leg {leg_s:.2f} s; "
              f"device stage card vs CPU {stage:.3g} px ({card})")
        out[key] = {"B": B_SLICE14, "gt_px": gt_px, "jax_cpu_reading_px":
                    reading, "limit_px": gt_limit(reading), "leg_s": leg_s,
                    "stage_vs_cpu_px": stage}
    return out


class _Recorder:
    """A cv2 tracker that keeps the (ok, box) answers it gives."""

    def __init__(self, impl):
        self.impl, self.answers = impl, []

    def init(self, img, box):
        return self.impl.init(img, box)

    def update(self, img):
        ans = self.impl.update(img)
        self.answers.append(ans)
        return ans


def _slice14_adapters(frames, box):
    """The cv2 adapters on this machine's cv2: `mil` (the registry's cv2
    tracker; the factory's `mil` key is the port's own MIL) for 6 frames,
    its corners equal to the boxes its cv2 object answered (two TrackerMIL
    objects on the same frames part by a pixel, so the raw tracker is the
    run the adapter drove); then csrt, visp and cv3 through the factory:
    a key the machine's cv2 has builds and runs, any other raises the JAX
    package's NotImplementedError with the list."""
    import cv2
    from mtf_tpu_torch import create_tracker, third_party
    avail = third_party.available()
    print(f"cv2 {cv2.__version__} trackers available: {avail}")
    rec = []
    if "mil" in avail:
        ad = third_party.CVTrackerAdapter(
            lambda: rec.append(_Recorder(cv2.TrackerMIL_create())) or rec[-1],
            "mil")
        st = ad.initialize(frames[0], box)
        for f in frames[1:]:
            st = ad.update(st, f)
            ok, (x, y, w, h) = rec[0].answers[-1]
            want = np.float32([[x, y], [x + w, y], [x + w, y + h],
                               [x, y + h]]) if ok else None
            got = ad.corners(st)[0].numpy().T
            _check(want is None or np.array_equal(got, want),
                   f"mil adapter: corners {got} for the box {want}")
    out = {"available": avail, "mil_frames": len(frames) - 1 if rec else 0}
    print(f"mil adapter: {out['mil_frames']} updates, each tracker's "
          "corners the box its cv2 object answered")
    for key in ("csrt", "visp", "cv3"):
        if key in avail:
            trk = create_tracker(key)
            st = trk.initialize(frames[0], box)
            for f in frames[1:]:
                st = trk.update(st, f)
            _check(np.isfinite(trk.corners(st).numpy()).all(),
                   f"{key}: corners not finite")
            out[key] = "ran"
        else:
            try:
                create_tracker(key)
                raise AssertionError(f"{key}: built without cv2's tracker")
            except NotImplementedError as e:
                _check("available in this environment" in str(e),
                       f"{key}: {e}")
                out[key] = "raised NotImplementedError"
        print(f"{key}: {out[key]}")
    return out


def _slice14_node(torch, tk, gf, dev, frames, box, card):
    """tracker_node in a subprocess on the card over the bridge, at
    fclk/ssd/8 with the bench configuration (K1 10 per update, read from
    the node's own counts), against the same tracker in-process: its
    corners file (4 decimals) within SLICE14_NODE_TOL_PX."""
    import json
    import os
    import tempfile

    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.bridge import SharedImageWriter
    from mtf_tpu_torch.utils import gt as gtio
    cfg = slice_cfg()
    pairs = ["sm", "fclk", "am", "ssd", "ssm", "8"] + slice13_pairs("fclk")
    h, w = frames[0].shape
    name = f"chip14_{os.getpid()}"
    writer = SharedImageWriter(name, h, w, 1)
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "node.txt")
        writer.write(frames[0])
        proc = subprocess.Popen(
            [sys.executable, "-c", SLICE14_NODE_SCRIPT, "--bridge", name,
             "--corners", ",".join(f"{v:.4f}" for v in box.reshape(-1)),
             "--n_frames", str(len(frames) - 1), "--timeout", "120",
             "--out", out_path] + pairs, stdout=subprocess.PIPE, text=True,
            cwd=repo, env={**os.environ, "PYTHONPATH": repo})
        try:
            line = proc.stdout.readline()
            _check(json.loads(line or "{}").get("event") == "initialized",
                   f"tracker_node: no readiness line ({line!r})")
            for t in range(1, len(frames)):
                writer.write(frames[t])
                rec = json.loads(proc.stdout.readline())
                _check(rec.get("frame") == t, f"tracker_node: line {rec}")
            counts = json.loads(proc.stdout.readline())
            _check(proc.wait(timeout=120) == 0, "tracker_node failed")
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            writer.close()
        node = gtio.read_corners_file(out_path)
    n_up = counts["updates"]
    _check(n_up == len(frames) - 1, f"tracker_node: {n_up} updates")
    for k, got in counts["launches"].items():
        want = MAX_ITERS * n_up if k == "ssd" else 0
        _check(got == want, f"tracker_node: {k} launched {got} times in "
               f"{n_up} updates")
    MAIN_PATH_LAUNCHES.update(counts["launches"])
    sm = create_tracker("fclk", "ssd", "8", device=dev, **cfg)
    st = sm.initialize(torch.as_tensor(frames[0], device=dev), box[None])
    ref = []
    for f in frames[1:]:
        st = sm.update(st, torch.as_tensor(f, device=dev))
        ref.append(sm.corners(st)[0].T.cpu().numpy())
    err = float(np.abs(node - np.stack(ref)).max())
    _check(err <= SLICE14_NODE_TOL_PX, f"tracker_node: corners {err} px "
           f"from the in-process tracker (limit {SLICE14_NODE_TOL_PX})")
    print(f"tracker_node: {n_up} updates in a subprocess on the card, ssd "
          f"{counts['launches'].get('ssd', 0)} launches, {err:.2g} px from "
          f"in-process ({card})")
    return {"updates": n_up, "launches": counts["launches"].get("ssd", 0),
            "vs_in_process_px": err}


def _slice14_app(tk, gf, main, argv, label, expect_per_update=None,
                 updates=0):
    """One app in-process on the card, its launches read: exactly
    `expect_per_update` (kernel: count) per update, 0 for every other."""
    _zero_counts(tk, gf)
    t0 = time.perf_counter()
    rc = main(argv)
    wall = time.perf_counter() - t0
    _check(rc == 0, f"{label}: exit code {rc}")
    counts = _counts(tk, gf)
    MAIN_PATH_LAUNCHES.update(counts)
    for k, got in counts.items():
        want = (expect_per_update or {}).get(k, 0) * updates
        _check(got == want, f"{label}: {k} launched {got} times (expected "
               f"{want} in {updates} updates)")
    return wall, {k: v for k, v in counts.items() if v}


def _slice14_parity(torch, tk, gf, card):
    """parity_cv2 at its defaults (20 frames), each contender's launches
    read (its trackers on the generic path, as the JAX package's
    `_fused_ok` routes gather taps: none); each of the port's rows within
    `gt_limit` of the JAX reading, and parity in both families."""
    from mtf_tpu_torch.apps import parity_cv2
    launches = {}

    def counted(name, fn):
        def run(fr, fr_np, gt):
            _zero_counts(tk, gf)
            errs = fn(fr, fr_np, gt)
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in _counts(tk, gf).items() if v}
            return errs
        return run

    rows = parity_cv2.head_to_head(
        contenders=[(f, n, counted(n, fn)) for f, n, fn
                    in parity_cv2.CONTENDERS])
    ver = parity_cv2.verdicts(rows)
    for r in rows:
        _check("error" not in r, f"parity_cv2: {r}")
        _check(not launches[r["tracker"]], f"parity_cv2 {r['tracker']}: "
               f"launched {launches[r['tracker']]}")
        reading = SLICE14_JAX_READING["parity"][r["tracker"]]
        if r["tracker"].startswith("mtf_tpu:"):
            _check(r["avg_mcd_px"] <= gt_limit(reading),
                   f"parity_cv2 {r['tracker']}: {r['avg_mcd_px']} px (limit "
                   f"{gt_limit(reading)}, JAX {reading})")
        print(f"parity_cv2 {r['tracker']}: avg_mcd {r['avg_mcd_px']} px "
              f"(JAX {reading}), {r['wall_s']} s ({card})")
    _check(len(ver) == 2 and all(v["parity"] for v in ver),
           f"parity_cv2: verdicts {ver}")
    return {"rows": rows, "verdicts": ver}


def _slice14_apps(torch, tk, gf, dev, tmp, card):
    """register_seq and create_mosaic at esm/ncc/8 (the bench
    configuration: ncc_esm 10 per update) on the slice-13 sequence, their
    outputs read back; track_markers and track_uav_trajectory against GT
    (limits from the JAX readings); generate_synthetic_seq,
    extract_patch, show_ground_truth and record_seq from a directory."""
    import os

    import cv2
    from mtf_tpu_torch.apps import (create_mosaic, extract_patch,
                                    generate_synthetic_seq, record_seq,
                                    register_seq, show_ground_truth,
                                    track_markers, track_uav_trajectory)
    from mtf_tpu_torch.utils import gt as gtio
    out, walls = {}, {}
    seq, gt_path, gt = slice13_sequence(tmp, dev)
    n = len(gt)
    pairs = ["sm", "esm", "am", "ncc", "ssm", "8"] + slice13_pairs("esm")
    esm = {"ncc_esm": MAX_ITERS}
    reg = os.path.join(tmp, "registered")
    walls["register_seq"], out["register_seq"] = _slice14_app(
        tk, gf, register_seq.main, ["--seq", seq, "--gt", gt_path,
                                    "--out_dir", reg] + pairs,
        "register_seq", esm, n - 1)
    imgs = sorted(os.listdir(reg))
    _check(len(imgs) == n and all(
        cv2.imread(os.path.join(reg, f), cv2.IMREAD_GRAYSCALE).shape
        == (480, 640) for f in imgs), "register_seq: outputs do not read back")
    mosaic = os.path.join(tmp, "mosaic.png")
    walls["create_mosaic"], out["create_mosaic"] = _slice14_app(
        tk, gf, create_mosaic.main,
        ["--seq", seq, "--out", mosaic, "sm", "esm", "am", "ncc", "ssm", "8"]
        + SLICE14_MOSAIC_PAIRS, "create_mosaic", esm, n - 1)
    m = cv2.imread(mosaic, cv2.IMREAD_GRAYSCALE)
    _check(m is not None and m.shape == (960, 1280) and m.max() > 0,
           "create_mosaic: the mosaic does not read back")
    # track_markers: feat, no kernel
    mseq, marker, mgt = slice14_marker_inputs(tmp, dev)
    mdir = os.path.join(tmp, "markers")
    walls["track_markers"], _ = _slice14_app(
        tk, gf, track_markers.main, ["--seq", mseq, "--markers", marker,
                                     "--out_dir", mdir], "track_markers")
    err = corner_error(gtio.read_corners_file(
        os.path.join(mdir, "marker_marker.txt")), mgt)
    reading = SLICE14_JAX_READING["track_markers_px"]
    _check(err <= gt_limit(reading), f"track_markers: {err} px from GT "
           f"(limit {gt_limit(reading)}, JAX {reading})")
    out["track_markers_px"] = err
    # track_uav_trajectory: esm/ncc/8 on the map, one update per frame
    map_path, useq, ugt = slice14_uav_inputs(tmp)
    udir = os.path.join(tmp, "uav")
    walls["track_uav_trajectory"], out["track_uav_trajectory"] = \
        _slice14_app(tk, gf, track_uav_trajectory.main,
                     ["--map", map_path, "--seq", useq, "--out_dir", udir]
                     + ["sm", "esm", "am", "ncc", "ssm", "8"]
                     + SLICE14_UAV_PAIRS, "track_uav_trajectory", esm,
                     len(ugt))
    err = corner_error(gtio.read_corners_file(
        os.path.join(udir, "uav_corners.txt")), ugt)
    reading = SLICE14_JAX_READING["track_uav_px"]
    _check(err <= gt_limit(reading), f"track_uav_trajectory: {err} px from "
           f"GT (limit {gt_limit(reading)}, JAX {reading})")
    out["track_uav_px"] = err
    # the sequence tools, from a directory source
    gen = os.path.join(tmp, "gen")
    walls["generate_synthetic_seq"], _ = _slice14_app(
        tk, gf, generate_synthetic_seq.main,
        ["--out_dir", gen, "--n_frames", str(SLICE14_GEN_FRAMES)],
        "generate_synthetic_seq")
    ggt = os.path.join(gen, "gt.txt")
    for label, main, argv in (
            ("extract_patch", extract_patch.main,
             ["--seq", gen, "--gt", ggt, "--out_dir",
              os.path.join(tmp, "patches")]),
            ("show_ground_truth", show_ground_truth.main,
             ["--seq", gen, "--gt", ggt, "--out_dir",
              os.path.join(tmp, "annotated")]),
            ("record_seq", record_seq.main,
             ["--source", gen, "--out_dir", os.path.join(tmp, "recorded")])):
        walls[label], _ = _slice14_app(tk, gf, main, argv, label)
    for d in ("patches", "annotated", "recorded"):
        _check(len(os.listdir(os.path.join(tmp, d))) == SLICE14_GEN_FRAMES,
               f"{d}: {len(os.listdir(os.path.join(tmp, d)))} frames")
    print("slice-14 apps: " + ", ".join(f"{k} {v:.2f} s"
                                         for k, v in walls.items())
          + f"; track_markers {out['track_markers_px']:.4f} px, "
          f"track_uav_trajectory {out['track_uav_px']:.4f} px from GT "
          f"({card})")
    out["wall_s"] = walls
    return out


def _slice14_examples(card):
    """The three demos on the card, in a fresh directory: each exits 0,
    the two trackers' demos within `gt_limit` of the JAX readings."""
    import os
    import tempfile

    from mtf_tpu_torch.examples import (composite_tracking_demo,
                                        simple_tracking_demo, warping_demo)
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for mod in (simple_tracking_demo, composite_tracking_demo,
                        warping_demo):
                name = mod.__name__.rsplit(".", 1)[1]
                _check(mod.main([]) == 0, f"{name}: nonzero exit")
            n_png = len(os.listdir(os.path.join(tmp, "log", "warping_demo")))
        finally:
            os.chdir(cwd)
    _check(n_png == 5, f"warping_demo: {n_png} sheets")
    simple = float(np.mean(simple_tracking_demo.LAST_ERRORS))
    reading = SLICE14_JAX_READING["simple_demo_px"]
    _check(simple <= gt_limit(reading), f"simple_tracking_demo: {simple} px "
           f"(limit {gt_limit(reading)}, JAX {reading})")
    out["simple_tracking_demo_px"] = simple
    for name, errs in composite_tracking_demo.LAST_ERRORS.items():
        got = float(np.mean(errs))
        reading = SLICE14_JAX_READING["composite_demo_px"][name]
        _check(got <= gt_limit(reading), f"composite demo {name}: {got} px "
               f"(limit {gt_limit(reading)}, JAX {reading})")
        out[f"composite {name}_px"] = got
    print("examples: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + f" ({card})")
    return out


def _slice14_phase(torch, tk, gf, card, dev):
    """Slice 14 on the card: feat and cmt (GT legs, device stage against
    the CPU's), the cv2 adapters, diagnose --validate and validate_chain,
    tracker_node over the bridge in a subprocess, parity_cv2 at its
    defaults, the other apps and the examples. Each check fails the run;
    each stage's seconds are kept, SLICE14_BUDGET_S the aim of the
    whole."""
    import os
    import tempfile

    from mtf_tpu_torch.am import AMParams, get_am
    from mtf_tpu_torch.apps import diagnose
    from mtf_tpu_torch.diagnostics import Diagnostics
    from mtf_tpu_torch.ssm import get_ssm
    t0 = time.perf_counter()
    out, stages = {}, {}

    def lap(name, t_prev):
        now = time.perf_counter()
        stages[name] = now - t_prev
        return now

    out["trackers"] = _slice14_trackers(torch, tk, gf, card, dev)
    t = lap("feat_cmt", t0)
    frames, _ = synthetic_sequence_host(torch, dev)
    box = _corners(1)[0]
    out["adapters"] = _slice14_adapters(frames, box)
    t = lap("adapters", t)
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts(tk, gf)
        rc = diagnose.main(["--am", "ncc", "--ssm", "8", "--validate",
                            "--out_dir", os.path.join(tmp, "log")])
        _check(rc == 0, f"diagnose --validate: exit code {rc}")
        h, w = frames[0].shape
        s = min(h, w) / 4
        corners = np.float32([[w / 2 - s, h / 2 - s], [w / 2 + s, h / 2 - s],
                              [w / 2 + s, h / 2 + s], [w / 2 - s, h / 2 + s]])
        chain = Diagnostics(get_am("ncc", AMParams(resx=25, resy=25)),
                            get_ssm("8", device=dev)).validate_chain(
            torch.as_tensor(frames[0], device=dev), corners)
        _check(chain["ok"], f"validate_chain: {chain}")
        _check(not any(_counts(tk, gf).values()), "diagnostics launched a "
               "kernel")
        out["diagnostics"] = {"validate_rc": rc, "chain": chain}
        print(f"diagnose --validate exit 0; validate_chain {chain} ({card})")
        t = lap("diagnostics", t)
        out["node"] = _slice14_node(torch, tk, gf, dev, frames, box, card)
        t = lap("tracker_node", t)
        out["parity_cv2"] = _slice14_parity(torch, tk, gf, card)
        t = lap("parity_cv2", t)
        out["apps"] = _slice14_apps(torch, tk, gf, dev, tmp, card)
        t = lap("apps", t)
    out["examples"] = _slice14_examples(card)
    lap("examples", t)
    out["stages_s"] = stages
    out["phase_s"] = time.perf_counter() - t0
    print("slice-14 stages: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in stages.items())
          + f"; {out['phase_s']:.1f} s (aim {SLICE14_BUDGET_S} s) ({card})")
    return out


def synthetic_sequence_host(torch, dev):
    """The blob scene along the homography's random walk from
    `_corners(1)` (6 frames rendered on the card) as host arrays: the
    adapters', diagnostics' and tracker node's frames."""
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    frames, gt = synthetic_sequence(blob_scene(), _corners(1)[0],
                                    get_ssm("8", device=dev),
                                    n_frames=SLICE14_NODE_FRAMES,
                                    sigma_scale=0.004, seed=3)
    return frames.cpu().numpy(), gt


# -- slice 15: per-tracker frames (update_multi) and the options ---------
# The per-tracker legs: SLICE15_SEQS synthetic sequences of the GT leg
# (6 frames, sigma 0.004) at seeds SLICE15_SEQ_SEEDS, drawn with the
# fleet's homography over all B trackers' corners; tracker b reads
# sequence b mod SLICE15_SEQS. Frame 0 is the scene in every sequence, so
# the fleet initialises on it, shared.
SLICE15_SEQS = 8
SLICE15_SEQ_SEEDS = tuple(range(3, 3 + SLICE15_SEQS))
SLICE15_STEPS = 20       # the timed window: update_multi calls, then update
SLICE15_REORDER_PX = 1e-5  # update_multi on copies vs update, where a
                           # path reorders sums (none known: bit for bit)
SLICE15_MEM_MARGIN = 4 * 2 ** 30   # the sub-tracker grid's leg: its peak
                                   # over its frames' bytes
SLICE15_GT_TRACKERS = 8  # the trackers the JAX reading covers, but for
# the deterministic option legs that lose trackers on the card, read over
# more of them: a share lost is not read from 8
SLICE15_READ_TRACKERS = {"fclk_ssd_crop_blocks": 128,
                         "fclk_ssd_constant": 128}
SLICE15_BUDGET_S = 90.0
B_SLICE15_DFT = 256
B_SLICE15_BORDER = 1024
B_SLICE15_ROUTING = 256  # the 3-update runs of every flagged mode and kind


def slice15_family():
    """The per-tracker fleets at the earlier slices' widths: {name: (SM
    key, AM, SSM key, B, configuration, launches per update, seeds)};
    `seeds` (None: one run) seed the draws of the stochastic and learned
    fleets, each seed a run of the leg."""
    sub = ssm_family()["subgrid"]
    return {
        "pf500": ("pffc", "ssim", "8", B_PF, PF500_CFG, {}, GT_SEEDS),
        "nn1k": ("nnic", "mi", "8", B_NN, NN1K_CFG, {}, GT_SEEDS),
        "lpfc_ssd": ("lpfc", "ssd", "8", B, slice_cfg(),
                     {"ssd": MAX_ITERS}, GT_SEEDS),
        "gtrn_ssd": ("gtrn", "ssd", "8", B_GTRN, slice_cfg(), {}, GT_SEEDS),
        "subgrid": ("grid", "ssd", "8", B_RKLT, sub[4], sub[5], (None,)),
        "dft_fclk": ("dft", "ssd", "8", B_SLICE15_DFT,
                     dict(slice_cfg(), dft_sm="fclk"),
                     {"ssd_mc": MAX_ITERS}, (None,)),
        "pfrk": ("pfrk", "ssd", "8", B_PF, stochastic_routing()["pfrk"][4],
                 {"ssd_esm": MAX_ITERS, "grid_flow@linear": K5_PER_UPDATE},
                 GT_SEEDS),
    }


def slice15_options():
    """The option legs on the shared-frame GT leg: {name: (SM key, AM, SSM
    key, B, configuration, launches per update, seeds)}. crop_blocks
    takes no coarse phases: the JAX package's blocked sampler raises on a
    coarse phase's decimated grid (ROADMAP Queue 3)."""
    return {
        "fclk_ssd_bf16": ("fclk", "ssd", "8", B,
                          dict(slice_cfg(), interp_bf16=True),
                          {"ssd+bf16": MAX_ITERS}, (None,)),
        "rklt_ssd_bf16": ("rklt", "ssd", "8", B_RKLT,
                          dict(rklt_cfg(), interp_bf16=True),
                          {"ssd_esm+bf16": MAX_ITERS,
                           "grid_flow@linear+bf16": K5_PER_UPDATE}, (None,)),
        "pf500_bf16": ("pffc", "ssim", "8", B_PF,
                       dict(PF500_CFG, interp_bf16=True), {}, GT_SEEDS),
        "fclk_ssd_crop_blocks": ("fclk", "ssd", "8", B,
                                 dict(slice_cfg(), coarse_pt_iters=(),
                                      crop_blocks=(2, 2)), {}, (None,)),
        "fclk_ssd_constant": ("fclk", "ssd", "8", B_SLICE15_BORDER,
                              dict(slice_cfg(), interp="linear",
                                   border="constant"), {}, (None,)),
        "fclk_ssd_highest": ("fclk", "ssd", "8", B,
                             dict(slice_cfg(), interp_precision="highest"),
                             {"ssd": MAX_ITERS}, (None,)),
    }


def slice15_corners(name, b):
    """The corners of a slice-15 leg: `_corners(b)`; for the constant
    border's leg, every odd tracker moved left until a quarter of its
    template lies beyond the frame's left edge."""
    c = _corners(b)
    if name == "fclk_ssd_constant":
        half = (c[1::2, 1, 0] - c[1::2, 0, 0]) / 2
        c[1::2, :, 0] += (0.5 * half + 0.37 - c[1::2, :, 0].mean(1))[:, None]
    return c


def slice15_sequences(scene, corners, ssm):
    """The SLICE15_SEQS sequences of the per-tracker legs: (frames (S, 6,
    H, W) on the SSM's device, GT (S, 6, B, 4, 2))."""
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    out = [synthetic_sequence(scene, corners, ssm, n_frames=6,
                              sigma_scale=0.004, seed=sd)
           for sd in SLICE15_SEQ_SEEDS]
    import torch
    return (torch.stack([f for f, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


# The JAX package's readings of the slice-15 legs on the CPU
# (scripts/port_slice15_reference_leg.py), first SLICE15_GT_TRACKERS
# trackers: {name: (the worst seed's mean px, each seed's median px (the
# mean of the per-frame medians), the most trackers lost of the 8)}.
# Per frame (seed 0; the script prints every seed's): pf500 mean 0.1613,
# 0.1408, 0.1254, 0.1261, 0.3847 (tracker 3 lost); nn1k median 0.3092,
# 0.3461, 0.3423, 0.5769, 0.8245 (5 lost; 3 and 6 at seeds 1 and 2);
# lpfc 0.1129, 0.0926, 0.0967, 0.076, 0.0939 (every seed the same to 4
# decimals); gtrn median 1.2773, 1.9965,
# 3.0443, 2.7108, 4.7448 (all 8 lost at every seed, as on the shared
# leg); subgrid 0.1923, 0.1695, 0.1924, 0.1943, 0.2063; dft_fclk 0.0503,
# 0.0509, 0.0396, 0.0423, 0.0439; pfrk (the JAX parts) 0.1163, 0.1002,
# 0.1083, 0.092, 0.0899; fclk bf16 0.1132, 0.0818, 0.0942, 0.0644,
# 0.0748; rklt bf16 0.1164, 0.0953, 0.1159, 0.0781, 0.0934; pf500 bf16
# 0.1195, 0.1248, 0.1419, 0.1061, 0.108; over 128 trackers: crop_blocks
# median 0.1232, 0.1081, 0.1054, 0.0818, 0.0654 (16 lost), the constant
# border's 64 inner trackers median 0.1119, 0.1074, 0.0941, 0.0935,
# 0.0684 (6 lost; within 0.0013 px of the replicate run), its 64 across
# the edge all lost (median 3.3459 px, at least 1.67 px from the
# replicate run: the zero border stays where the scene moves, so their
# templates' outer quarter contradicts every frame); interp_precision
# highest 0.1107, 0.0837, 0.0923, 0.0646, 0.0731 (the default's).
SLICE15_JAX_READING = {
    "pf500": (0.1877, (0.1228, 0.1280, 0.1227), 1),
    "nn1k": (1.5828, (0.4798, 0.3422, 0.7623), 6),
    "lpfc_ssd": (0.0944, (0.0901, 0.0901, 0.0901), 0),
    "gtrn_ssd": (3.8938, (2.7547, 3.5662, 2.5987), 8),
    "subgrid": (0.1910, (0.1560,), 0),
    "dft_fclk": (0.0454, (0.0432,), 0),
    "pfrk": (0.1019, (0.1010, 0.0998, 0.1023), 0),
    "fclk_ssd_bf16": (0.0857, (0.0824,), 0),
    "rklt_ssd_bf16": (0.0998, (0.0993,), 0),
    "pf500_bf16": (0.1557, (0.1147, 0.1157, 0.1187), 0),
    "fclk_ssd_crop_blocks": (0.1902, (0.0968,), 16),   # of 128
    "fclk_ssd_constant": (0.3079, (0.0951,), 6),   # of its 64 inner ones
    "fclk_ssd_highest": (0.0849, (0.0805,), 0),
}
# the legs whose draws differ between the packages (the PF's, NN's, LP's
# and RegNet's): each card seed another sample of the same distribution
SLICE15_DRAWS_DIFFER = ("pf500", "nn1k", "lpfc_ssd", "gtrn_ssd", "pfrk",
                        "pf500_bf16")


def slice15_limits(name, n):
    """How a slice-15 leg of n trackers is held. A leg whose draws differ
    between the packages (SLICE15_DRAWS_DIFFER), or one that loses
    trackers in the JAX package: ("median", `learned_limit` of the JAX
    seeds' medians, the most it may lose: the JAX package's worst count
    of the trackers it read (8, or SLICE15_READ_TRACKERS), plus one where
    the draws differ (a reading of 8 trackers resolves a share to one in
    8; over a wider reading, 3 binomial standard deviations of its count),
    as a share of n, plus LOST_MARGIN); else ("mean", the JAX mean's
    `gt_limit`, 0)."""
    mean, medians, lost = SLICE15_JAX_READING[name]
    if lost == 0 and name not in SLICE15_DRAWS_DIFFER:
        return "mean", gt_limit(mean), 0
    lost += name in SLICE15_DRAWS_DIFFER
    read = SLICE15_READ_TRACKERS.get(name, SLICE15_GT_TRACKERS)
    if name == "fclk_ssd_constant":
        read //= 2                            # its inner trackers
    share = lost / read + LOST_MARGIN
    if read > SLICE15_GT_TRACKERS:
        # a wider reading: its count plus 3 binomial standard deviations
        share += 3 * np.sqrt(max(lost, 1) * (1 - lost / read)) / read
    return "median", learned_limit(medians), min(n, int(np.ceil(share * n)))


def _slice15_held(e, name, label):
    """A slice-15 leg's errors e (B, 5) held by `slice15_limits`; returns
    its row."""
    rule, limit, max_lost = slice15_limits(name, len(e))
    e = np.where(np.isfinite(e), e, np.inf)     # a non-finite tracker: lost
    mean = float(np.mean(e))
    med = float(np.median(e, 0).mean())
    lost = int((~(e.max(1) <= LOST_PX)).sum())
    first = float(np.mean(e[:SLICE15_GT_TRACKERS]))
    print(f"{label} GT: mean {mean:.4f} px, median {med:.4f} px (per frame "
          f"{[round(float(x), 4) for x in np.median(e, 0)]}), {lost} of "
          f"{len(e)} lost; first {SLICE15_GT_TRACKERS} trackers' mean "
          f"{first:.4f}; held by the {rule} (limit {limit:.4f} px"
          + (f", at most {max_lost} lost" if rule == "median" else "")
          + f"; JAX reading {SLICE15_JAX_READING[name]})")
    if rule == "mean":
        _check(np.isfinite(mean) and mean <= limit,
               f"{label} GT mean {mean} px (limit {limit})")
    else:
        _check(np.isfinite(med) and med <= limit,
               f"{label} GT median {med} px (limit {limit})")
        _check(lost <= max_lost, f"{label}: {lost} lost (limit {max_lost})")
    return {"gt_px": mean, "gt_median_px": med, "lost": lost,
            "first8_px": first, "rule": rule, "limit_px": limit}


def _slice15_counts(tk, gf, expect, n, label):
    """The launch counts since the last zeroing, each exactly expect x n
    (0 for a kernel not named); added to MAIN_PATH_LAUNCHES."""
    counts = _counts(tk, gf)
    MAIN_PATH_LAUNCHES.update(counts)
    for name, got in counts.items():
        want = expect.get(name, 0)
        lo, hi = want if isinstance(want, tuple) else (want, want)
        _check(lo * n <= got <= hi * n, f"{label}: {name} launched {got} "
               f"times in {n} updates (expected {want} per update)")
    return {k: counts[k] for k in expect}


def _slice15_fleet(torch, tk, gf, card, dev, name, spec, frame0, frame_d):
    """One per-tracker fleet of `slice15_family` at its B: (a)
    `update_multi` on B copies of a frame against `update` on it (bit for
    bit, else within SLICE15_REORDER_PX); (b) the per-tracker GT leg at
    each seed, tracker b on sequence b mod SLICE15_SEQS (`_slice15_held`);
    for the sub-tracker grid the peak memory of its leg over what it held
    before, under the frames' bytes plus SLICE15_MEM_MARGIN; (c) exact
    launches and (d) a timed window of SLICE15_STEPS `update_multi` calls
    on one update's frames, then as many `update` calls on the scene.
    Returns its row."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    from mtf_tpu_torch.ssm import get_ssm
    key, am, ssm, b, cfg, expect, seeds = spec
    label = f"slice 15 {name} ({key}/{am}/{ssm}) update_multi"
    t0 = time.perf_counter()
    corners = slice15_corners(name, b)
    seqs, gts = slice15_sequences(frame0, corners,
                                  get_ssm("8", device=dev))
    idx = torch.arange(b, device=dev) % SLICE15_SEQS
    sel = np.arange(b) % SLICE15_SEQS
    row = {"B": b, "seeds": {}}
    start = None
    for i, seed in enumerate(seeds):
        sm = create_tracker(key, am, ssm, device=dev,
                            **(cfg if seed is None else dict(cfg, seed=seed)))
        st = sm.initialize(seqs[0, 0], corners)
        if i == 0:
            # (a) B copies of one frame against the shared frame
            f1 = seqs[0, 1]
            a = sm.corners(sm.update_multi(
                st, f1.expand((b,) + tuple(f1.shape)).contiguous()))
            u = sm.corners(sm.update(st, f1))
            row["copies_exact"] = bool(torch.equal(a, u))
            row["copies_px"] = float((a - u).abs().max())
            print(f"{label}: on {b} copies of a frame against update: "
                  + ("bit for bit" if row["copies_exact"] else
                     f"max {row['copies_px']:.3g} px"))
            _check(row["copies_exact"]
                   or row["copies_px"] <= SLICE15_REORDER_PX,
                   f"{label}: update_multi on copies {row['copies_px']} px "
                   f"from update")
            del a, u
            start = (sm, st)         # the timed window's start, below
        # (b) the per-tracker GT leg
        fleet = TrackerFleet(sm)
        if name == "subgrid":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        errs = []
        for t in range(1, seqs.shape[1]):
            st = fleet.update_multi(st, seqs[idx, t])
            c = fleet.corners(st).cpu().numpy().transpose(0, 2, 1)
            errs.append(np.linalg.norm(c - gts[sel, t, np.arange(b)],
                                       axis=-1).mean(-1))
        if name == "subgrid":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            frames_b = b * seqs[0, 0].numel() * 4
            row["peak_bytes"], row["frames_bytes"] = peak, frames_b
            print(f"{label}: peak {peak / 2**30:.3f} GiB over its leg, "
                  f"against its per-tracker frames' {frames_b / 2**30:.3f} "
                  f"GiB + {SLICE15_MEM_MARGIN / 2**30:.0f} GiB ({card})")
            _check(peak <= frames_b + SLICE15_MEM_MARGIN,
                   f"{label}: peak {peak} B over its leg")
        row["seeds"][str(seed)] = _slice15_held(
            np.stack(errs, 1), name, f"{label} seed {seed}")
    # (c), (d): exact launches, update_multi and update timed, from the
    # first seed's init
    sm, st = start
    fleet = TrackerFleet(sm, donate=True)
    frames1 = seqs[idx, 1]
    st = fleet.update_multi(st, frames1)
    torch.cuda.synchronize()
    _zero_counts(tk, gf)
    t1 = time.perf_counter()
    for _ in range(SLICE15_STEPS):
        st = fleet.update_multi(st, frames1)
    torch.cuda.synchronize()
    row["update_multi_ms"] = (time.perf_counter() - t1) / SLICE15_STEPS * 1e3
    row["launches"] = _slice15_counts(tk, gf, expect, SLICE15_STEPS, label)
    del frames1
    _zero_counts(tk, gf)
    t1 = time.perf_counter()
    for _ in range(SLICE15_STEPS):
        st = fleet.update(st, frame_d)
    torch.cuda.synchronize()
    row["update_ms"] = (time.perf_counter() - t1) / SLICE15_STEPS * 1e3
    _slice15_counts(tk, gf, expect, SLICE15_STEPS, f"{label} (update)")
    # RegNet's step can grow a lost tracker's scale to float32 overflow
    # (SLICE10_NOT_FINITE); the others none
    bad = int((~torch.isfinite(fleet.corners(st)).flatten(1).all(1)).sum())
    limit = (not_finite_limit(SLICE10_NOT_FINITE["gtrn_ssd"])
             if name == "gtrn_ssd" else 0)
    row["not_finite"] = bad
    _check(bad <= limit, f"{label}: {bad} trackers' corners not finite "
           f"(limit {limit})")
    row["fps_multi"] = b / row["update_multi_ms"] * 1e3
    row["fps"] = b / row["update_ms"] * 1e3
    row["wall_s"] = time.perf_counter() - t0
    print(f"{label} B={b}: update_multi {row['update_multi_ms']:.2f} ms "
          f"({row['fps_multi']:.1f} frames/s), update "
          f"{row['update_ms']:.2f} ms ({row['fps']:.1f} frames/s); launches "
          f"{row['launches']} per {SLICE15_STEPS} updates; "
          f"{row['wall_s']:.1f} s ({card})")
    return row


def _slice15_option(torch, tk, gf, card, dev, name, spec, frame0, frame_d):
    """One option leg of `slice15_options`: WARMUP updates through the
    entry points with exact launches (`_fleet`), the shared GT leg at each
    seed (`_slice15_held`), the plain-path check of the flagged kernels'
    legs, and for the constant border the replicate run's corners, which
    must differ on every tracker that crosses the edge. Returns its
    row."""
    from mtf_tpu_torch import create_tracker
    key, am, ssm, b, cfg, expect, seeds = spec
    label = f"slice 15 {name} ({key}/{am}/{ssm})"
    t0 = time.perf_counter()
    corners = slice15_corners(name, b)
    sm, _, got = _fleet(torch, key, am, b, card, corners, frame_d, dev, tk,
                        gf, expect, windows=0, cfg=cfg, label=label)
    row = {"B": b, "launches": got, "seeds": {}}
    frames = None
    for seed in seeds:
        sm_s = sm if seed is None else create_tracker(
            key, am, ssm, device=dev, **dict(cfg, seed=seed))
        e, frames = _gt_errors(sm_s, frame0, corners)
        if name == "fclk_ssd_constant":
            # the trackers across the edge are lost in the JAX package too
            # (SLICE15_JAX_READING): the inner ones are held, the edge
            # ones' change with the border is checked below
            edge = np.where(np.isfinite(e[1::2]), e[1::2], np.inf)
            row["edge_median_px"] = float(np.median(edge, 0).mean())
            row["edge_lost"] = int((~(edge.max(1) <= LOST_PX)).sum())
            print(f"{label}: the {len(edge)} trackers across the edge: "
                  f"median {row['edge_median_px']:.4f} px, "
                  f"{row['edge_lost']} lost (the JAX package: 3.3459 px, "
                  f"all 64 of its 128 lost)")
            e = e[0::2]
        row["seeds"][str(seed)] = _slice15_held(e, name,
                                                f"{label} seed {seed}")
    if name in ("fclk_ssd_bf16", "rklt_ssd_bf16"):
        row["plain_path_px"] = _plain_path_check(
            sm, key, am, frames, corners, label, cfg=cfg, lm_ties=False)[0]
    if name == "fclk_ssd_constant":
        rep = create_tracker(key, am, ssm, device=dev,
                             **dict(cfg, border="replicate"))
        c_con = sm.corners(sm.update(sm.initialize(frame_d, corners),
                                     frames[1]))
        c_rep = rep.corners(rep.update(rep.initialize(frame_d, corners),
                                       frames[1]))
        d = (c_con - c_rep).abs().flatten(1).amax(1).cpu().numpy()
        d = np.where(np.isnan(d), np.inf, d)        # one went non-finite
        row["edge_min_px"] = float(d[1::2].min())
        row["inner_max_px"] = float(d[0::2].max())
        print(f"{label}: constant against replicate corners: the edge "
              f"trackers differ by {row['edge_min_px']:.4f} px at least, "
              f"the inner ones by {row['inner_max_px']:.3g} at most")
        _check(row["edge_min_px"] > 1e-3, f"{label}: an edge tracker's "
               f"corners do not change with the border")
    row["wall_s"] = time.perf_counter() - t0
    return row


def _slice15_precision(torch, tk, gf, card, dev, frame_d):
    """`interp_precision="highest"` on fclk/ssd/8 (B): 3 updates with the
    same corners, bit for bit, and the same launches as the default."""
    from mtf_tpu_torch import create_tracker
    out = []
    for cfg in (slice_cfg(), dict(slice_cfg(), interp_precision="highest")):
        sm = create_tracker("fclk", "ssd", "8", device=dev, **cfg)
        st = sm.initialize(frame_d, _corners(B))
        _zero_counts(tk, gf)
        for _ in range(WARMUP):
            st = sm.update(st, torch.roll(frame_d, (1, 1), (0, 1)))
        out.append((sm.corners(st), _slice15_counts(
            tk, gf, {"ssd": MAX_ITERS}, WARMUP,
            f"slice 15 fclk/ssd interp_precision {cfg.get('interp_precision')}"
        )))
    same = bool(torch.equal(out[0][0], out[1][0]))
    print(f"slice 15 interp_precision highest against the default: corners "
          f"{'equal' if same else 'differ'}, launches {out[1][1]} / "
          f"{out[0][1]} ({card})")
    _check(same and out[0][1] == out[1][1], "interp_precision highest "
           "changed the corners or the launches")
    return {"equal": same, "launches": out[1][1]}


def _k5_bf16_check(torch, gf, call, name, card):
    """One recorded grid-flow call with the bfloat16-operand flag (the
    window rounded) against its plain form under the flag. A bfloat16
    weight turns a float32 ulp of a point's coordinate into a bfloat16
    one, and the two forms sum the displacement in different orders, so
    after the first iteration their coordinates part by ulps: the call is
    held iteration by iteration on the plain form's trajectory (each
    iteration's step from the same points, by K5_TOL, K5_OVER_SHARE and
    K5_MAX); the whole launch's difference is printed beside it. Timed as
    `_k5_check`. Returns its row."""
    win, pts, templ, scale, n, n_iters, kind = call
    win = win.bfloat16().float()
    args = (win, pts, templ, scale, n, n_iters, True, kind, True)
    got = gf.grid_flow(*args)
    want = gf.grid_flow_ref(*args)
    whole = float((got - want).abs().max())
    disp, steps = torch.zeros_like(want), []
    for _ in range(n_iters):
        off = (disp * scale[:, None, None]).repeat_interleave(n, dim=1)
        p_it = (pts + off.transpose(1, 2)).contiguous()
        step_k = gf.grid_flow(win, p_it, templ, scale, n, 1, True, kind, True)
        step_p = gf.grid_flow_ref(win, p_it, templ, scale, n, 1, True, kind,
                                  True)
        steps.append((step_k - step_p).abs().flatten())
        disp = disp + step_p
    d = torch.cat(steps)
    row = dict(n=n, iters=n_iters, kind=kind, err=float(d.max()),
               whole_err=whole, n_over=int((d > K5_TOL).sum()),
               n_steps=d.numel() // 2)
    print(f"{name}: per-iteration |ddisp| max {row['err']:.3g}, "
          f"{row['n_over']} of {row['n_steps']} patch steps over {K5_TOL}; "
          f"the whole launch {whole:.3g}")
    _check(row["err"] <= K5_MAX and row["n_over"] <= K5_OVER_SHARE
           * row["n_steps"], f"{name}: cuda vs plain per-iteration disp "
           f"{row['err']} (limit {K5_MAX}), {row['n_over']} over {K5_TOL}")
    row["ms"] = _graph_ms(torch, lambda: gf.grid_flow(*args))
    row["plain_ms"] = _time_ms(torch, lambda: gf.grid_flow_ref(*args), 2)
    (row["bound_ms"], row["bound_by"], row["bytes"],
     row["flops"]) = _k5_bound(torch, win, pts, want, scale, n, n_iters,
                               kind)
    print(f"{name} B={win.shape[0]} n={n} iters={n_iters}: cuda "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) ({card})")
    return row


def _slice15_kernels(torch, tk, gf, card, dev, frames, rows, rows_k5):
    """The flagged instantiations against their plain forms under the flag
    at S = 8, N = 2500 (`_chain_row` on a window rounded to bfloat16:
    every mode with each tap kind, the multi-channel one at C = 3), each
    timed beside its unflagged row of `rows`; K5 and K5c flagged at both
    rklt levels (`_k5_bf16_check`) beside `rows_k5`. Returns ({mode:
    row}, {kind: {level: row}})."""
    out = {}
    for am, esm, c, kind, b in _kernel_specs():
        if c not in (1, 3):
            continue
        mode = tk.mode_name(am, esm, c > 1, kind, bf16=True)
        args, j0 = _chain_inputs(torch, frames[c], N_POINTS[-1], b, am, esm,
                                 dev)
        args = (args[0].bfloat16().float(),) + tuple(args[1:])
        row = _chain_row(torch, tk, args, j0, am, esm, kind, 0,
                         f"{_label(am, esm, c > 1, kind)} {mode} C={c} "
                         f"N={N_POINTS[-1]} B={b}", card, 1, bf16=True, b=b,
                         c=c)
        row["unflagged_ms"] = rows[(tk.mode_name(am, esm, c > 1, kind),
                                    N_POINTS[-1], c)]["ms"]
        out[mode] = row
        del args, j0
    torch.cuda.empty_cache()
    k5 = {}
    corners = _corners(B_RKLT)
    for kind in KINDS:
        k5[kind] = {}
        for call in _k5_operands(torch, corners, frames[1], dev,
                                 cfg=cfg_of("rklt", f"{kind}_mm")):
            level = "1" if call[5] > 1 else "0"
            name = "K5" if kind == "linear" else "K5c"
            r = _k5_bf16_check(torch, gf, call, f"{name}+bf16 {kind} rklt "
                               f"level {level}", card)
            r["unflagged_ms"] = rows_k5[kind][level]["ms"]
            k5[kind][level] = r
    return out, k5


def slice15_bf16_routing(tk):
    """Every flagged instantiation through the entry points, 3 updates at
    B_SLICE15_ROUTING: {name: (SM key, AM, configuration, launches per
    update)}: each chain-kernel mode with each tap kind (the mode's
    fleet's configuration with `interp_bf16`), and rklt with each kind
    (K5 / K5c with the flag)."""
    out = {}
    for kind in KINDS:
        interp = f"{kind}_mm"
        for key, am, m_am, esm, mc in (("fclk", "ssd", "ssd", False, False),
                                       ("fclk", "ncc", "ncc", False, False),
                                       ("esm", "ssd", "ssd", True, False),
                                       ("esm", "ncc", "ncc", True, False),
                                       ("fclk", "mcssd", "ssd", False, True)):
            mode = tk.mode_name(m_am, esm, mc, kind, bf16=True)
            out[f"{key}_{am}_{kind}"] = (key, am, dict(
                slice_cfg(interp), interp_bf16=True), {mode: MAX_ITERS})
        out[f"rklt_ssd_{kind}"] = ("rklt", "ssd", dict(
            cfg_of("rklt", interp), interp_bf16=True),
            {tk.mode_name("ssd", True, False, kind, bf16=True): MAX_ITERS,
             f"grid_flow@{kind}+bf16": K5_PER_UPDATE})
    return out


def _slice15_phase(torch, tk, gf, card, dev, frame0, frame_d, frames, rows,
                   rows_k5):
    """Slice 15 on the card: the flagged kernels against their plain
    forms (`_slice15_kernels`), the per-tracker fleets
    (`_slice15_fleet`), the option legs (`_slice15_option`), the
    precision check and the flagged routing runs. SLICE15_BUDGET_S is the
    aim of the whole. Returns its rows."""
    t0 = time.perf_counter()
    stages, out = {}, {}

    def lap(name, t_prev):
        now = time.perf_counter()
        stages[name] = now - t_prev
        return now

    out["kernels"], out["k5"] = _slice15_kernels(torch, tk, gf, card, dev,
                                                 frames, rows, rows_k5)
    t = lap("kernels", t0)
    out["fleets"] = {}
    for name, spec in slice15_family().items():
        out["fleets"][name] = _slice15_fleet(torch, tk, gf, card, dev, name,
                                             spec, frame0, frame_d)
        torch.cuda.empty_cache()
    t = lap("fleets", t)
    out["options"] = {}
    for name, spec in slice15_options().items():
        out["options"][name] = _slice15_option(torch, tk, gf, card, dev,
                                               name, spec, frame0, frame_d)
        torch.cuda.empty_cache()
    out["precision"] = _slice15_precision(torch, tk, gf, card, dev, frame_d)
    t = lap("options", t)
    out["routing"] = {}
    for name, (key, am, cfg, expect) in slice15_bf16_routing(tk).items():
        b = B_SLICE15_ROUTING
        frm = frames[3] if am == "mcssd" else frame_d
        _, _, got = _fleet(torch, key, am, b, card, _corners(b), frm, dev,
                           tk, gf, expect, windows=0, cfg=cfg,
                           label=f"slice 15 bf16 {name}")
        out["routing"][name] = got
    torch.cuda.empty_cache()
    lap("routing", t)
    out["stages_s"] = stages
    out["phase_s"] = time.perf_counter() - t0
    print("slice-15 stages: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in stages.items())
          + f"; {out['phase_s']:.1f} s (aim {SLICE15_BUDGET_S} s) ({card})")
    return out


def _slice15_entries(tk, slice15, usage_bf16):
    """The kernels line's entries of the flagged instantiations: each
    chain-kernel mode and kind at S = 8 and K5 / K5c per kind, with their
    main-path launches (the slice-15 legs and routing runs)."""
    out = []
    for mode, row in slice15["kernels"].items():
        am, esm, mc, kind = next(
            i for i in tk.INSTANTIATIONS
            if tk.mode_name(*i, bf16=True) == mode)
        regs, st, ld = usage_bf16["chain"][(8, am, esm, mc, kind)]
        out.append({
            "name": f"lk_fused_chain[{mode}] ({_label(am, esm, mc, kind)} "
                    "with the bfloat16-operand flag)",
            "route": "cuda", "source": SOURCE,
            "replaces": REPLACES + " (interp_bf16: mtf_tpu/ops/interp.py:"
                        "269-294)",
            "launches": MAIN_PATH_LAUNCHES[mode],
            "max_abs_err": row["err_v"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "unflagged_ms": row["unflagged_ms"],
            "shape": f"B={row['b']}, " + (f"C={row['c']}, " if mc else "")
                     + f"window {CROP}x{CROP}, N=2500, {kind} taps",
            "registers": regs, "spill_stores": st, "spill_loads": ld,
            "max_raw_rel_err": row["err_raw"]})
    for kind, levels in slice15["k5"].items():
        k = "K5" if kind == "linear" else "K5c"
        regs = [u[0] for (_, kd), u in usage_bf16["k5"].items() if kd == kind]
        out.append({
            "name": f"grid_flow[{kind}+bf16] ({k} with the bfloat16-operand "
                    "flag)",
            "route": "cuda", "source": K5_SOURCE,
            "replaces": (K5_REPLACES if kind == "linear" else K5C_REPLACES)
                        + " (interp_bf16: mtf_tpu/sm/grid.py:213-221)",
            "launches": MAIN_PATH_LAUNCHES[f"grid_flow@{kind}+bf16"],
            "max_abs_err": max(r["err"] for r in levels.values()),
            "ms": sum(r["ms"] for r in levels.values()),
            "plain_ms": sum(r["plain_ms"] for r in levels.values()),
            "bound_ms": sum(r["bound_ms"] for r in levels.values()),
            "bound_by": levels["1"]["bound_by"], "library_ms": None,
            "unflagged_ms": sum(r["unflagged_ms"] for r in levels.values()),
            "shape": f"rklt B={B_RKLT}, P=100, both levels",
            "registers": [min(regs), max(regs)],
            "by_level": {lv: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                               "err", "whole_err")}
                         for lv, r in levels.items()}})
    return out


# -- slice 11: the parallel layer ----------------------------------------
# -- slice 16: the sub-tracker grid without a crop ------------------------
# `ssm_family`'s sub-tracker grid with no window: its B·P sub-trackers read
# the whole 480x640 frame, shared (the chain kernel at a batch stride of
# 0), or with `update_multi` their parents' frames by index (one chain
# launch per parent frame and iteration: B runs of P sub-trackers)
SLICE16_UPDATES = 3      # the untimed legs' updates (iclk, update_multi)
SLICE16_STEPS = 5        # the fused leg's timed updates (host clock)
SLICE16_MULTI_B = 16     # parents of the update_multi leg's timed run
# The JAX package's reading of the fused leg on the CPU, first 8 trackers
# (scripts/port_slice16_reference_leg.py); per frame: see PERF.md
SLICE16_GT_READING_PX = {"subgrid_nocrop": 0.2359}


def slice16_family():
    """The no-crop sub-tracker grid legs: {name: (SM key, AM, SSM key, B,
    configuration, launches per update)}: fclk/ssd/2 sub-trackers on the
    chain kernel (`ssm_family`'s configuration, crop None), and ICLK ones
    (the JAX package's own no-crop test's `grid_sm`) on the generic
    path, which launches no kernel."""
    key, am, ssm, b, cfg, expect, _ = ssm_family()["subgrid"]
    nocrop = dict(cfg, crop=None)
    return {
        "subgrid_nocrop": (key, am, ssm, b, nocrop, expect),
        "subgrid_iclk_nocrop": (key, am, ssm, b,
                                dict(nocrop, grid_sm="iclk"), {}),
    }


def shared_chain_inputs(torch, frame, n, b, dev, seed=2):
    """Chain-kernel operands of the sub-tracker grid without a crop: the
    whole frame (H, W) read by B trackers at a batch stride of 0,
    translation (S = 2) warps of the stride-decimated 8x8 template grid,
    4-12 px wide, centred anywhere within 8 px of the frame (some reach
    past its edges: the kernel's clamps at frame size), random templates
    (as `_subgrid_phase`'s)."""
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.ssm import get_ssm
    rng = np.random.default_rng(seed)
    h, w = frame.shape
    side = int(round(n ** 0.5))
    g = W.unit_square_grid(side, side, device=dev)
    ph = torch.cat([g.T, torch.ones(1, n, device=dev)])
    ph = ph.expand(b, 3, n).contiguous()
    ssm = get_ssm("2", device=dev)
    norm = np.zeros((b, 3, 3), np.float32)
    norm[:, 0, 0] = norm[:, 1, 1] = rng.uniform(4.0, 12.0, b)
    norm[:, 0, 2] = rng.uniform(-8.0, w + 8.0, b)
    norm[:, 1, 2] = rng.uniform(-8.0, h + 8.0, b)
    norm[:, 2, 2] = 1.0
    state = torch.as_tensor(rng.normal(0, 0.02, (b, 2)), dtype=torch.float32,
                            device=dev)
    M0 = (torch.as_tensor(norm, device=dev)
          @ ssm.to_matrix(state)).contiguous()
    templ = torch.as_tensor(rng.uniform(0, 255, (b, n)), dtype=torch.float32,
                            device=dev)
    return frame.expand(b, h, w), M0, ssm.generators, ph, templ


def _slice16_kernels(torch, tk, frame_d, card, dev):
    """ssd:s2 on the shared frame at the no-crop leg's shapes (B_RKLT x
    100 sub-trackers, N = 16 and 64) against its plain form
    (`_chain_row`). Returns {N: row}."""
    rows, b = {}, B_RKLT * 100
    h, w = frame_d.shape
    for n in (16, 64):
        args = shared_chain_inputs(torch, frame_d, n, b, dev)
        mode = tk.mode_name("ssd", False, False, "linear", 2)
        rows[n] = _chain_row(
            torch, tk, args, None, "ssd", False, "linear", 0,
            f"K1 sub-grid no crop {mode} N={n} B={b} window {h}x{w} (the "
            "frame, shared)", card, 2, b=b, c=1)
        del args
        torch.cuda.empty_cache()
    return rows


def _slice16_grid(torch, tk, gf, card, dev, name, spec, corners, frame0,
                  frame_d):
    """One `update` leg of `slice16_family` (or `ssm_family`'s crop-32
    grid) at B: exact launches over WARMUP updates and a timed window of
    STEPS (`_fleet`), then PROFILED_UPDATES updates under the profiler
    from a fresh init with its peak memory over them; for a fleet whose
    GT reading is in SLICE16_GT_READING_PX, its GT leg and plain-path
    check. Returns (its row, the tracker)."""
    from mtf_tpu_torch.parallel import TrackerFleet
    key, am, ssm, b, cfg, expect = spec
    label = f"slice 16 {name} ({key}/{am}/{ssm})"
    t0 = time.perf_counter()
    sm, fps, got = _fleet(torch, key, am, b, card, corners, frame_d, dev, tk,
                          gf, expect, windows=1, cfg=cfg, label=label)
    fleet = TrackerFleet(sm)
    st = fleet.initialize(frame_d, corners)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dev_ms, per_update, st = _profile_updates(torch, fleet, st, frame_d,
                                              top=3, label=label)
    peak = torch.cuda.max_memory_allocated() - base
    row = {"B": b, "sub_trackers": b * sm.grid.grid_res ** 2, "fps": fps,
           "update_ms": b / fps * 1e3, "device_ms": dev_ms,
           "busy_share": dev_ms / (b / fps * 1e3),
           "device_kernels_per_update": per_update, "peak_bytes": peak,
           "launches": got}
    print(f"{label} B={b}: update {row['update_ms']:.2f} ms, device "
          f"{dev_ms:.3f} ms per update ({per_update:.0f} device kernels), "
          f"peak {peak / 2**30:.3f} GiB over {PROFILED_UPDATES} updates "
          f"({card})")
    reading = SLICE16_GT_READING_PX.get(name)
    if reading is not None:
        row["gt_px"], frames = _gt_leg(sm, frame0, corners,
                                       gt_limit(reading), label)
        row.update(gt_limit_px=gt_limit(reading), jax_cpu_reading_px=reading)
        row["plain_path_px"] = _plain_path_check(sm, key, am, frames, corners,
                                                 label, cfg=cfg)[0]
        del frames
    row["wall_s"] = time.perf_counter() - t0
    return row, sm


def _slice16_multi(torch, tk, gf, card, dev, sm, corners, frame_d):
    """The no-crop grid's `update_multi`: on B copies of the frame against
    `update` (bit for bit), then on per-tracker frames (tracker b on the
    frame shifted by (b mod 3, b mod 8 // 3) px), 1 warm-up and
    SLICE16_UPDATES timed updates with exact launches: one chain launch
    per parent frame and iteration, B x 10 per update."""
    from mtf_tpu_torch.parallel import TrackerFleet
    b = corners.shape[0]
    label = "slice 16 subgrid_nocrop update_multi"
    st = sm.initialize(frame_d, corners)
    a = sm.corners(sm.update_multi(st, frame_d.expand(
        (b,) + tuple(frame_d.shape)).contiguous()))
    u = sm.corners(sm.update(st, frame_d))
    row = {"B": b, "copies_exact": bool(torch.equal(a, u)),
           "copies_px": float((a - u).abs().max())}
    print(f"{label}: on {b} copies of the frame against update: "
          + ("bit for bit" if row["copies_exact"]
             else f"max {row['copies_px']:.3g} px"))
    _check(row["copies_exact"], f"{label}: update_multi on copies "
           f"{row['copies_px']} px from update")
    del a, u
    shifts = [(k % 3, k // 3) for k in range(8)]
    stack = torch.stack([torch.roll(frame_d, sh, (0, 1)) for sh in shifts])
    frames = stack[torch.arange(b, device=dev) % len(shifts)]
    fleet = TrackerFleet(sm, donate=True)
    st = fleet.update_multi(st, frames)
    torch.cuda.synchronize()
    _zero_counts(tk, gf)
    t1 = time.perf_counter()
    for _ in range(SLICE16_UPDATES):
        st = fleet.update_multi(st, frames)
    torch.cuda.synchronize()
    row["update_multi_ms"] = ((time.perf_counter() - t1) / SLICE16_UPDATES
                              * 1e3)
    row["launches"] = _slice15_counts(tk, gf, {"ssd:s2": b * MAX_ITERS},
                                      SLICE16_UPDATES, label)
    bad = int((~torch.isfinite(fleet.corners(st)).flatten(1).all(1)).sum())
    row["not_finite"] = bad
    _check(bad == 0, f"{label}: {bad} trackers' corners not finite")
    print(f"{label} B={b}: {row['update_multi_ms']:.2f} ms per update, "
          f"launches {row['launches']} in {SLICE16_UPDATES} updates "
          f"({b} runs x {MAX_ITERS} iterations each) ({card})")
    return row


def _slice16_phase(torch, tk, gf, card, dev, frame0, frame_d, corners):
    """Slice 16 on the card: the kernel on the shared frame
    (`_slice16_kernels`), the crop-32 and no-crop grids' `update` legs
    (`_slice16_grid`), the no-crop grid's `update_multi`
    (`_slice16_multi`) and 3 updates of the ICLK sub-trackers' grid with
    exact launches (none). Returns its rows."""
    t0 = time.perf_counter()
    out = {"kernels": _slice16_kernels(torch, tk, frame_d, card, dev)}
    fam = slice16_family()
    sub = ssm_family()["subgrid"]
    out["subgrid_crop32"], _ = _slice16_grid(
        torch, tk, gf, card, dev, "subgrid_crop32", sub[:6], corners, frame0,
        frame_d)
    torch.cuda.empty_cache()
    out["subgrid_nocrop"], sm = _slice16_grid(
        torch, tk, gf, card, dev, "subgrid_nocrop", fam["subgrid_nocrop"],
        corners, frame0, frame_d)
    torch.cuda.empty_cache()
    out["update_multi"] = _slice16_multi(torch, tk, gf, card, dev, sm,
                                         corners, frame_d)
    del sm
    torch.cuda.empty_cache()
    key, am, ssm, b, cfg, expect = fam["subgrid_iclk_nocrop"]
    t1, timing = time.perf_counter(), {}
    _, _, got = _fleet(torch, key, am, b, card, corners, frame_d, dev, tk,
                       gf, expect, windows=0, warmup=SLICE16_UPDATES,
                       cfg=cfg, label=f"slice 16 subgrid_iclk_nocrop "
                                      f"({key}/{am}/{ssm})", timing=timing)
    wall = time.perf_counter() - t1
    out["subgrid_iclk_nocrop"] = {
        "B": b, "updates": SLICE16_UPDATES, "launches": got, "wall_s": wall,
        "init_s": timing["init_s"],
        "update_ms": (wall - timing["init_s"]) / SLICE16_UPDATES * 1e3}
    print(f"slice 16 subgrid_iclk_nocrop B={b}: init "
          f"{timing['init_s']:.3f} s, then "
          f"{out['subgrid_iclk_nocrop']['update_ms']:.2f} ms per update "
          f"(host clock, with the tracker's build) ({card})")
    torch.cuda.empty_cache()
    nc, cr = out["subgrid_nocrop"], out["subgrid_crop32"]
    out["nocrop_vs_crop32"] = {k: nc[k] / cr[k] for k in
                               ("update_ms", "device_ms", "peak_bytes")}
    out["phase_s"] = time.perf_counter() - t0
    print(f"slice-16: no crop / crop 32 update "
          f"{out['nocrop_vs_crop32']['update_ms']:.3f}, device "
          f"{out['nocrop_vs_crop32']['device_ms']:.3f}, peak "
          f"{out['nocrop_vs_crop32']['peak_bytes']:.3f}; phase "
          f"{out['phase_s']:.1f} s ({card})")
    return out


def _slice16_entry(tk, slice16, usage):
    """The kernels line's entry of ssd:s2 on the shared frame: the N = 64
    row as the headline, both point counts under `by_n`; `launches` are
    the no-crop grid's main-path launches (`update`, then
    `update_multi`)."""
    rows = slice16["kernels"]
    head = rows[64]
    regs, sst, sld = usage[(2, "ssd", False, False, "linear", False)]
    by_leg = {"update": slice16["subgrid_nocrop"]["launches"]["ssd:s2"],
              "update_multi": slice16["update_multi"]["launches"]["ssd:s2"]}
    return {
        "name": "lk_fused_chain[ssd:s2] sub-grid without a crop (K1 at "
                "S = 2 on the whole frame, shared)",
        "route": "cuda", "source": SOURCE,
        "replaces": f"{REPLACES} (n_s = gens.shape[0], :519)",
        "launches": sum(by_leg.values()), "launches_by_leg": by_leg,
        "max_abs_err": max(r["err_v"] for r in rows.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"B={head['b']} sub-trackers, the 480x640 frame at batch "
                 "stride 0, N=64 (by_n: 16 in the stride-2 phase), linear "
                 "taps, S=2",
        "registers": regs, "spill_stores": sst, "spill_loads": sld,
        "by_n": {str(n): _sub(r) for n, r in sorted(rows.items())},
    }


B_SCALING = 64           # bench.py's strong-scaling row: 64 trackers
SCALING_WIDTHS = (1, 2, 4, 8)
PARALLEL_UPDATES = 2     # updates of each sharded path and its reference
SCALING_WINDOWS = 5      # calls of the strong-scaling protocol
PARALLEL_TOL_PX = 1e-4   # a sharded path against the unsharded one
MULTI_SINGLES = 8        # trackers re-run alone on their own frames
MULTI_SHIFT_SEED = 11    # the per-tracker sub-pixel offsets
PARALLEL_AXES = ("tracker", "particle", "sample", "patch", "pixel")


def _shifted_stack(torch, img, offs):
    """(B, H, W) frames: img (H, W) on the card with its content moved
    by offs (B, 2) px (x, y) each, by bilinear resampling with replicate
    edges (`grid_sample`, in chunks of 128 frames)."""
    F = torch.nn.functional
    h, w = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    out = torch.empty((offs.shape[0], h, w), device=img.device)
    for i in range(0, offs.shape[0], 128):
        o = offs[i:i + 128]
        b = o.shape[0]
        gx = 2.0 * (xs[None, None, :] - o[:, 0, None, None]) / (w - 1) - 1.0
        gy = 2.0 * (ys[None, :, None] - o[:, 1, None, None]) / (h - 1) - 1.0
        grid = torch.stack([gx.expand(b, h, w), gy.expand(b, h, w)], -1)
        out[i:i + b] = F.grid_sample(
            img[None, None].expand(b, 1, h, w), grid, mode="bilinear",
            padding_mode="border", align_corners=True)[:, 0]
    return out


def _parallel_checks(rank, world, light=False, device_type="cuda"):
    """Every check of the parallel phase on a world of `world` ranks,
    each rank on its card (`init_distributed` done): each sharded path at
    full width against the port's unsharded path on the same draws, the
    launches of each sharded path per rank, `update_multi`'s and
    `track_sequence`'s GT legs, the dry run and the strong-scaling row.
    `light`: the 2-rank gloo world on one card, which skips the
    scaling row (its ranks share one card). `device_type` "cpu" runs it
    on the CPU (a dry run of this script's code, at smaller B). Returns {"diffs", "gt",
    "launches", "scaling", "seconds"}; raises on any failed check."""
    import torch
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    from mtf_tpu_torch.ops.kernels import lk_fused as tk
    from mtf_tpu_torch.parallel import (ShardedGridTracker, ShardedNN,
                                        ShardedPF, TrackerFleet, make_mesh,
                                        sharded_gn_step)
    from mtf_tpu_torch.parallel.dryrun import dryrun
    from mtf_tpu_torch.parallel.multihost import measure_fleet_scaling
    from mtf_tpu_torch.sm.composite import RKLT, CascadeSM
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    meshes = {ax: make_mesh({ax: world}, device_type)
              for ax in PARALLEL_AXES}
    one = make_mesh({"pixel": 1}, device_type)
    frame0 = _scene(0)
    frame_d = torch.as_tensor(frame0, device=dev)
    frames = [frame_d, torch.roll(frame_d, (1, 1), (0, 1))]
    out = {"diffs": {}, "gt": {}, "launches": collections.Counter(),
           "scaling": None}

    def counted(label, expect, n_updates, fn):
        """fn() with the launch counts zeroed before and read after; each
        kernel exactly `expect[name]` times per update on this rank."""
        _zero_counts(tk, gf)
        res = fn()
        counts = _counts(tk, gf)
        out["launches"].update(counts)
        for name, got in counts.items():
            want = expect.get(name, 0) * n_updates
            _check(got == want, f"parallel {label} (rank {rank}): {name} "
                   f"launched {got} times in {n_updates} updates "
                   f"(expected {want})")
        return res

    def held(label, got, want, tol=PARALLEL_TOL_PX):
        d = float((torch.as_tensor(got) - torch.as_tensor(want).to(
            got.device)).abs().max())
        _check(d <= tol, f"parallel {label}: sharded and unsharded corners "
               f"{d} px apart (limit {tol})")
        out["diffs"][label] = d

    def steps(sm_step, st):
        for i in range(PARALLEL_UPDATES):
            st = sm_step(st, frames[(i + 1) % 2])
        return st

    # the headline fleet, tracker-sharded
    corners = _corners(B)
    sm = create_tracker("fclk", "ssd", "8", device=dev, **cfg_of("fclk"))
    fleet = TrackerFleet(sm, meshes["tracker"], donate=True)
    plain = TrackerFleet(sm, donate=True)
    st = counted("fleet", {"ssd": MAX_ITERS}, PARALLEL_UPDATES,
                 lambda: steps(fleet.update, fleet.initialize(
                     frame_d, corners)))
    held("fleet", fleet.corners(st), plain.corners(steps(
        plain.update, plain.initialize(frame_d, corners))))

    # update_multi: one frame per tracker, the scene moved by a sub-pixel
    # offset each; 8 trackers alone on their own frames
    offs = np.random.default_rng(MULTI_SHIFT_SEED).uniform(
        -0.5, 0.5, (B, 2)).astype(np.float32)
    offs_d = torch.as_tensor(offs, device=dev)
    stack = _shifted_stack(torch, frames[1], offs_d)
    st = counted("update_multi", {"ssd": MAX_ITERS}, 1,
                 lambda: fleet.update_multi(fleet.initialize(
                     frame_d, corners), stack))
    got = fleet.corners(st)
    picks = np.linspace(0, B - 1, MULTI_SINGLES).astype(int)
    alone = torch.cat([sm.corners(sm.update(sm.initialize(
        frame_d, corners[b:b + 1]), stack[b])) for b in picks])
    held("update_multi", got[picks], alone)
    # the same on whole frames (no crop): the chain kernel reads the
    # per-tracker stack itself
    sm_nc = create_tracker("fclk", "ssd", "8", device=dev,
                           **dict(cfg_of("fclk"), crop=None))
    fleet_nc = TrackerFleet(sm_nc, meshes["tracker"])
    st = counted("update_multi_no_crop", {"ssd": MAX_ITERS}, 1,
                 lambda: fleet_nc.update_multi(fleet_nc.initialize(
                     frame_d, corners), stack))
    got = fleet_nc.corners(st)
    alone = torch.cat([sm_nc.corners(sm_nc.update(sm_nc.initialize(
        frame_d, corners[b:b + 1]), stack[b])) for b in picks])
    held("update_multi_no_crop", got[picks], alone)
    del stack, st, fleet_nc, sm_nc
    torch.cuda.empty_cache()
    seq, gt = synthetic_sequence(frame0, corners, sm.ssm, n_frames=6,
                                 sigma_scale=0.004, seed=3)
    seq = torch.as_tensor(seq, device=dev)
    st = fleet.initialize(seq[0], corners)
    errs = []
    for t in range(1, len(seq)):
        st = fleet.update_multi(st, _shifted_stack(torch, seq[t], offs_d))
        c = fleet.corners(st).cpu().numpy().transpose(0, 2, 1)
        errs.append(float(np.linalg.norm(c - (gt[t] + offs[:, None]),
                                         axis=-1).mean()))
    out["gt"]["update_multi"] = float(np.mean(errs))
    _check(out["gt"]["update_multi"] <= GT_LIMIT_PX,
           f"update_multi GT {out['gt']['update_multi']} px")

    # track_sequence over the GT leg: the update loop's corners, and GT
    _, cs = fleet.track_sequence(fleet.initialize(seq[0], corners), seq[1:])
    st, loop = fleet.initialize(seq[0], corners), []
    for t in range(1, len(seq)):
        st = fleet.update(st, seq[t])
        loop.append(fleet.corners(st))
    held("track_sequence", cs, torch.stack(loop), 0.0)
    e = np.linalg.norm(cs.cpu().numpy().transpose(0, 1, 3, 2) - gt[1:],
                       axis=-1).mean()
    out["gt"]["track_sequence"] = float(e)
    _check(e <= GT_LIMIT_PX, f"track_sequence GT {e} px")
    del seq, fleet, plain, sm
    torch.cuda.empty_cache()

    # ShardedNN at nn1k's configuration and ShardedPF at pf500's (no top-K
    # rescore), each the first stage of its cascade
    for label, key, am, b, cfg, shard in (
            ("nn1k", "nnic", "mi", B_NN, NN1K_CFG, lambda m: ShardedNN(
                m.am, m.ssm, m.prm, m.nn, mesh=meshes["sample"])),
            ("pf500", "pffc", "ssim", B_PF, dict(PF500_CFG,
                                                 pf_rescore_top_k=0),
             lambda m: ShardedPF(m.am, m.ssm, m.prm, m.pf,
                                 mesh=meshes["particle"]))):
        sm = create_tracker(key, am, "8", device=dev, **cfg)
        sharded = CascadeSM([shard(sm.members[0])] + list(sm.members[1:]))
        crn = _corners(b)
        st = counted(label, {}, PARALLEL_UPDATES, lambda: steps(
            sharded.update, sharded.initialize(frame_d, crn)))
        held(label, sharded.corners(st), sm.corners(steps(
            sm.update, sm.initialize(frame_d, crn))))
        del sm, sharded
        torch.cuda.empty_cache()

    # ShardedGridTracker inside the rklt row
    crn = _corners(B_RKLT)
    sm = create_tracker("rklt", "ssd", "8", device=dev, **rklt_cfg())
    g = sm.grid_sm
    srk = RKLT(ShardedGridTracker(g.am, g.ssm, g.prm, g.grid,
                                  mesh=meshes["patch"]), sm.templ_sm, sm.prm)
    st = counted("rklt", {"ssd_esm": MAX_ITERS,
                          "grid_flow@linear": K5_PER_UPDATE},
                 PARALLEL_UPDATES, lambda: steps(
                     srk.update, srk.initialize(frame_d, crn)))
    held("rklt", srk.corners(st), sm.corners(steps(
        sm.update, sm.initialize(frame_d, crn))))
    del sm, srk

    # sharded_gn_step on the headline's shapes, SSD, local
    sm = create_tracker("fclk", "ssd", "8", device=dev, **cfg_of("fclk"))
    st = sm.initialize(frame_d, corners)
    got = sm.corners(counted("gn_step", {}, 1, lambda: sharded_gn_step(
        sm, st, frames[1], meshes["pixel"], "pixel", "local")))
    if rank == 0:
        held("gn_step", got, sm.corners(sharded_gn_step(
            sm, st, frames[1], one, "pixel", "local")))
    del sm, st
    torch.cuda.empty_cache()

    # the dry run (gather taps: no kernel) and the strong-scaling row
    # (SCALING_WINDOWS calls; each width a warm-up and STEPS timed updates
    # on the ranks of its mesh)
    counted("dryrun", {}, 0, lambda: dryrun(dev))
    if not light:
        sm = create_tracker("fclk", "ssd", "8", device=dev, **cfg_of("fclk"))
        crn = _corners(B_SCALING, seed=2)
        widths = tuple(n for n in SCALING_WIDTHS if n <= world)
        runs = counted(
            "scaling", {"ssd": MAX_ITERS},
            SCALING_WINDOWS * (STEPS + 1) * sum(rank < n for n in widths),
            lambda: [measure_fleet_scaling(
                sm, frame_d, lambda i: crn[i], widths=widths, steps=STEPS,
                fixed_total=B_SCALING) for _ in range(SCALING_WINDOWS)])
        out["scaling"] = {n: sorted(r["fps"][n] for r in runs)
                          for n in runs[0]["fps"]}
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = dict(out["launches"])
    return out if rank == 0 else None


def _parallel_report(label, res, card):
    for name, d in res["diffs"].items():
        print(f"parallel {label} {name}: sharded vs unsharded corners "
              f"{d:.3g} px apart (limit {PARALLEL_TOL_PX})")
    for name, e in res["gt"].items():
        print(f"parallel {label} {name} GT: mean corner error {e:.4f} px "
              f"(limit {GT_LIMIT_PX})")
    print(f"parallel {label} launches per rank: " + ", ".join(
        f"{k} {v}" for k, v in sorted(res["launches"].items()) if v))
    if res["scaling"]:
        sc = res["scaling"]
        base = statistics.median(next(iter(sc.values())))
        print(f"parallel {label} strong scaling, {B_SCALING} trackers, "
              f"{SCALING_WINDOWS} windows of {STEPS} updates: " + ", ".join(
                  f"{n} rank(s) median {statistics.median(f):.1f} frames/s "
                  f"(windows {', '.join(f'{x:.1f}' for x in f)}; efficiency "
                  f"{statistics.median(f) / base:.3f})"
                  for n, f in sc.items()) + f" ({card})")
    print(f"parallel {label}: {res['seconds']:.1f} s")


def _parallel_phase(torch, card):
    """Slice 11: the checks of `_parallel_checks` on a world of one rank
    per card under NCCL, then on 2 ranks sharing card 0 under gloo with
    CUDA tensors (NCCL takes one rank per card). Any rank's failure in
    either world fails the phase."""
    import torch.distributed as dist
    from mtf_tpu_torch.parallel.multihost import init_distributed, run_world
    n = torch.cuda.device_count()
    print(f"parallel world size: {n} (nccl, one rank per card)")
    if n == 1:
        init_distributed(backend="nccl", device_type="cuda")
        try:
            res = _parallel_checks(0, 1)
        finally:
            dist.destroy_process_group()
    else:
        res = run_world(_parallel_checks, n, backend="nccl",
                        device_type="cuda", timeout=600)[0]
    _parallel_report(f"world {n} nccl", res, card)
    MAIN_PATH_LAUNCHES.update(res["launches"])
    print("parallel world size: 2 (gloo, CUDA tensors, both ranks on "
          "card 0)")
    res2 = run_world(_parallel_checks, 2, (True,), backend="gloo",
                     device_type="cuda", timeout=600)[0]
    _parallel_report("world 2 gloo", res2, card)
    MAIN_PATH_LAUNCHES.update(res2["launches"])
    return {"world": n, "nccl": res, "gloo_2_ranks_one_card": res2}


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
    try:
        import cv2
        print(f"cv2 {cv2.__version__} imports (slice 7's cv2 trackers)")
    except ImportError as e:
        print(f"cv2 does not import: {e}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.load_all(build_specs(tk, gf))
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
    usage_bf16 = _bf16_usage(tk, gf, libs)
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
                                n_points=N_POINTS[-1:], plain_reps=3)
              for st in NEW_S}
    # K4b: the blurred taps in every mode and kind at S = 8 and 6
    _zero_counts(tk, gf)
    rows_b = {}
    for st in K4B_S:
        for blur, n in K4B_CASES:
            rows_b[(st, blur)] = _kernel_phase(
                torch, tk, frames, card, dev, s=st, blur=blur,
                specs=[sp for sp in _kernel_specs() if sp[2] in (1, 3)],
                n_points=(n,), plain_reps=2)
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
    plain2 = _plain_path_check(sm, "esm", "ncc", frames, corners2,
                               "esm/ncc")[0]
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
                                 "rklt/ssd")[0]
    planted_rk = not _plain_path_check(sm, "rklt", "ssd", frames, corners_rk,
                                       "rklt/ssd",
                                       planted=PLAIN_PATH_FAULT)[2]
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
                                 "fclk/mcssd")[0]
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
                                    f"fclk/ssd {interp}", interp)[0]
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
        plain = _plain_path_check(sm, key, am, frames, crn, label,
                                  cfg=cfg)[0]
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
                                  boundary=PLAIN_PATH_BOUNDARY.get(name))[0]
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

    # -- slice 8: the generic LK path ----------------------------------------
    generic = _generic_phase(torch, tk, gf, card, dev, frame0, frame_d,
                             frame3_d)
    torch.cuda.empty_cache()

    # -- slice 9: the particle filter and nearest-neighbour search ---------
    t9 = time.perf_counter()
    stochastic = _stochastic_phase(torch, tk, gf, card, dev, frame0, frame_d)
    slice9_s = time.perf_counter() - t9
    print(f"slice 9 phase: {slice9_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 10: the other AMs and ILMs, LP, RegNet, hesm, the line ------
    t10 = time.perf_counter()
    slice10 = _slice10_phase(torch, tk, gf, card, dev, frame0, frame_d,
                             frame3_d)
    slice10_s = time.perf_counter() - t10
    print(f"slice 10 phase: {slice10_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 12: the box trackers (CF, learn, DFT, TLD) --------------------
    t12 = time.perf_counter()
    slice12 = _slice12_phase(torch, tk, gf, card, dev, frame0, frame_d)
    slice12_s = time.perf_counter() - t12
    print(f"slice 12 phase: {slice12_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 13: run_mtf, the fleet protocol, the APIs, eval_suite ---------
    t13 = time.perf_counter()
    slice13 = _slice13_phase(torch, tk, gf, card, dev)
    slice13_s = time.perf_counter() - t13
    print(f"slice 13 phase: {slice13_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 14: the cv2 trackers, diagnostics, the bridge, the apps -------
    t14 = time.perf_counter()
    slice14 = _slice14_phase(torch, tk, gf, card, dev)
    slice14_s = time.perf_counter() - t14
    print(f"slice 14 phase: {slice14_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 15: per-tracker frames and the options ------------------------
    t15 = time.perf_counter()
    slice15 = _slice15_phase(torch, tk, gf, card, dev, frame0, frame_d,
                             {1: frame_d, 3: frame3_d}, rows, rows_k5)
    slice15_s = time.perf_counter() - t15
    print(f"slice 15 phase: {slice15_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 16: the sub-tracker grid without a crop -----------------------
    t16 = time.perf_counter()
    slice16 = _slice16_phase(torch, tk, gf, card, dev, frame0, frame_d,
                             corners_rk)
    slice16_s = time.perf_counter() - t16
    print(f"slice 16 phase: {slice16_s:.1f} s")
    torch.cuda.empty_cache()
    # -- slice 11: the parallel layer ---------------------------------------
    t11 = time.perf_counter()
    parallel = _parallel_phase(torch, card)
    slice11_s = time.perf_counter() - t11
    print(f"slice 11 phase: {slice11_s:.1f} s")
    torch.cuda.empty_cache()
    # the routing runs that reach the grid flow (gric, rklt_ssd_spi, pfrk,
    # nnrk, line) count in K5's main-path launches too, and the slice-10
    # runs at S = 2 (hesm, hrch) in the chain kernel's
    for name, res in (("parallel nccl", parallel["nccl"]),
                      ("parallel gloo", parallel["gloo_2_ranks_one_card"])):
        if res and res.get("launches"):
            k5_launches["linear"][name] = res["launches"].get(
                "grid_flow@linear", 0)
    k5_launches["linear"]["run_mtf rklt_ssd"] = (
        slice13["rklt_ssd"]["launches"]["grid_flow@linear"])
    for row_set in (generic, stochastic, slice10, slice12):
        for name, row in row_set.items():
            for k, v in row.get("launches", {}).items():
                if k.startswith("grid_flow@"):
                    k5_launches[k.split("@")[1]][name] = v
                elif row_set is slice10 and ":s2" in k:
                    launches_s[2][k] = launches_s[2].get(k, 0) + v

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
            "launches": MAIN_PATH_LAUNCHES[mode],
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
    kernels += _slice15_entries(tk, slice15, usage_bf16)
    kernels.append(_slice16_entry(tk, slice16, usage))
    rule = _rule_summary([rows, rows_sub, rows_gn, slice16["kernels"]]
                         + list(rows_s.values()) + list(rows_b.values()))
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
                                "planted_fault_rejected": planted_rk,
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
                   **family, **ssm_fleets, **generic, **stochastic,
                   **slice10, **slice12},
        "raw_sum_rule": rule,
        "build_s": {k: v.seconds for k, v in libs.items()},
        "slice9_phase_s": slice9_s,
        "slice10_phase_s": slice10_s,
        "slice12_phase_s": slice12_s,
        "slice13": slice13,
        "slice13_phase_s": slice13_s,
        "slice14": slice14,
        "slice14_phase_s": slice14_s,
        "slice15": slice15,
        "slice15_phase_s": slice15_s,
        "slice16": slice16,
        "slice16_phase_s": slice16_s,
        "parallel": parallel,
        "slice11_phase_s": slice11_s,
        "wall_s": time.perf_counter() - t_start,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
