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

    def likelihood(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """exp(-alpha * the RMS residual) (SSDBase.cc:64)."""
        f = self.f(state, patch)
        n = state.template.shape[-2] * state.template.shape[-1]
        return torch.exp(-self.prm.likelihood_alpha
                         * torch.sqrt(torch.clamp(-2.0 * f / n, min=0.0)))
