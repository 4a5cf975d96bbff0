"""Search methods (port of `mtf_tpu/sm/`)."""
from mtf_tpu_torch.sm.core import (SearchMethod, SMParams,  # noqa: F401
                                   TrackerState)
