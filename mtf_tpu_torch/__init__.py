"""PyTorch/CUDA port of `mtf_tpu` for NVIDIA Hopper (H100).

The port keeps the JAX package's module layout (`mtf_tpu_torch/ops/warp.py`
is the counterpart of `mtf_tpu/ops/warp.py`, and so on) and is held
against it by `tests/test_torch_*.py`. It never imports JAX.

Idiom: plain functions on tensors with an explicit leading batch axis B
(in place of `vmap`), fixed-count Python loops (in place of
`lax.while_loop`), a `device` on every entry point (None means the card;
`device="cpu"` runs on the CPU), and `NamedTuple`s of tensors for tracker
state.

Slices covered: FCLK and ESM, each optionally with Levenberg-Marquardt
(`fclm`, `eslm`), with the SSD or NCC appearance model on the 8-DOF
homography, dense linear sampling from a hoisted crop and coarse-to-fine
point decimation, batched as a tracker fleet; and RKLT, the grid tracker
(pyramidal patch flow fused by RANSAC, LMedS or least squares) refined
by ESM-LM. Two TPU kernels are on those paths, each a CUDA kernel: the
chain-fused LK iteration (`csrc/lk_fused_chain.cu`) in four
instantiations, SSD and NCC moments, each with and without ESM's
template-Jacobian operand; and the grid flow (`csrc/grid_flow.cu`), all
iterations of a pyramid level for every patch in one launch.
"""
import torch

# Every 3x3 warp product on the tracking path ran at Precision.HIGHEST in
# JAX: rounding the image-scale translations showed up as a ~1 px
# tracking bias. TF32 keeps ~3 decimal digits, so keep float32 matmuls
# and convolutions at full float32 precision on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mtf_tpu_torch.factory import create_tracker  # noqa: E402,F401
