"""Normalized cross-correlation appearance model (port of
`mtf_tpu/am/ncc.py`)."""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState


class NCC(AM):
    """f = mean over channels of the correlation of the centred, unit-norm
    patch with the centred, unit-norm template, per tracker, over patches
    (B, N, C)."""
    name = "ncc"

    @staticmethod
    def _center_norm(patch: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        c = patch - patch.mean(dim=-2, keepdim=True)
        return c / (torch.linalg.vector_norm(c, dim=-2, keepdim=True) + eps)

    def _init_extra(self, patch0: torch.Tensor):
        # cache the normalized template (reference init_pix_norm)
        return (self._center_norm(patch0),)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        n0 = state.extra[0]
        return (n0 * self._center_norm(patch)).sum(dim=-2).mean(dim=-1)

    def likelihood(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """exp(-alpha (1 - f))."""
        return torch.exp(-self.prm.likelihood_alpha
                         * (1.0 - self.f(state, patch)))

    def dist_feat(self, patch: torch.Tensor) -> torch.Tensor:
        """The centred unit patch (..., N·C), n·C + c."""
        return self._center_norm(patch).flatten(-2)

    def update_model(self, state: AMState, patch: torch.Tensor) -> AMState:
        st = super().update_model(state, patch)
        if self.prm.learning_rate > 0.0:
            st = st._replace(extra=(self._center_norm(st.template),))
        return st
