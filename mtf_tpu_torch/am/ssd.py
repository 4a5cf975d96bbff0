"""SSD appearance model (port of `mtf_tpu/am/ssd.py`)."""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState


class SSD(AM):
    """f = -||It - I0||^2 / 2 per tracker, over patches (B, N, C): every
    channel of a multi-channel patch (the `mcssd` / `ssd3` keys,
    `AMParams.n_channels` 3) adds to one sum."""
    name = "ssd"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        r = patch - state.template
        return -0.5 * (r * r).sum(dim=(-2, -1))
