"""PyTorch/CUDA port of `mtf_tpu` for NVIDIA Hopper (H100).

The port keeps the JAX package's module layout (`mtf_tpu_torch/ops/warp.py`
is the counterpart of `mtf_tpu/ops/warp.py`, and so on) and is held
against it by `tests/test_torch_*.py`. It never imports JAX.

Idiom: plain functions on tensors with an explicit leading batch axis B
(in place of `vmap`), fixed-count Python loops (in place of
`lax.while_loop`), a `device` on every entry point (None means the card;
`device="cpu"` runs on the CPU), and `NamedTuple`s of tensors for tracker
state.

Slices covered: every LK search method of the JAX package (FCLK, ICLK,
ESM, AESM, FALK, IALK, FCSD, each optionally with Levenberg-Marquardt)
with any appearance model of the JAX package (SSD, NSSD, ZNCC, SAD, NCC,
SSIM, SPSS, MI, CCRE, KLD, LKLD, the SCV family, RIU, NGF, PCA, DFM and
the sum of two) on any number of channels, with or without an
illumination model (GB, PGB, RBF), the particle filter and the
nearest-neighbour search (exact or by kNN-graph descent) and their
cascades, the linear predictor, RegNet, the hierarchical SMs, every
SSM (the matrix SSMs, spline and TPS), every Hessian flavour, SPI masks
and done masks; the chain-fused path where the JAX package's `_fused_ok`
takes its kernel, the generic `torch.func` path elsewhere; batched as a
tracker fleet; the grid tracker (pyramidal patch flow in the `warped`,
`rigid` or `f2f` geometry, optionally forward-backward masked, fused by
RANSAC, LMedS, least squares or the median-flow similarity: Median
Flow, or snapped to row and column lines: the line tracker), the
sub-tracker grid, RKLT (the grid refined by ESM-LM, with SPI
feedback), and the Cascade, Parallel and Pyramidal composites; and the
box trackers (the correlation filters MOSSE, KCF and DSST on gray or fHOG
features, RCT, MIL, Boosting, Struck, FragTrack, DFT on the descriptor
fields, and TLD). Every
TPU kernel is a CUDA kernel: the chain-fused LK iteration
(`csrc/lk_fused_chain.cu`) in all its modes and tap kinds, its
precomputed-Jacobian form (`csrc/lk_fused_gn.cu`), and the grid flow
(`csrc/grid_flow.cu`), all iterations of a pyramid level for every
patch in one launch, with linear or cubic taps.

The user entry points are ported too: `apps.run_mtf` (the evaluation
protocol of runMTF), `apps.eval_suite`, pyMTF (`api`), pyMTF2 (`api2`),
the mex front end (`api_mex`), `video_capture` and `utils/` (config,
metrics, GT files, datasets, frame input, viz, checkpoints, profiling),
and so are the OpenCV trackers (the feature tracker, CMT, the cv2
tracking-API adapters of `third_party`), `diagnostics`, the
shared-memory `bridge`, the other apps (`diagnose`, `tracker_node`,
`parity_cv2`, `register_seq`, `create_mosaic`, `generate_synthetic_seq`,
`extract_patch`, `show_ground_truth`, `record_seq`, `track_markers`,
`track_uav_trajectory`) and the demos of `examples/`.
"""
import torch

# Every 3x3 warp product on the tracking path ran at Precision.HIGHEST in
# JAX: rounding the image-scale translations showed up as a ~1 px
# tracking bias. TF32 keeps ~3 decimal digits, so keep float32 matmuls
# and convolutions at full float32 precision on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mtf_tpu_torch.am import get_am  # noqa: E402,F401
from mtf_tpu_torch.factory import create_tracker  # noqa: E402,F401
from mtf_tpu_torch.ssm import get_ssm  # noqa: E402,F401
