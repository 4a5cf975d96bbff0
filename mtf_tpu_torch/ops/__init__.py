"""Image and warp operations (port of `mtf_tpu/ops/`)."""
from mtf_tpu_torch.ops import interp, warp  # noqa: F401
