"""Structural-similarity appearance models (port of `mtf_tpu/am/ssim.py`):
SSIM and SPSS, over patches (..., N, C)."""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState


class SSIM(AM):
    """Single-window SSIM over the whole patch, per channel, averaged."""
    name = "ssim"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        c1 = self.prm.extra.get("c1", 6.5025)    # (k1 L)^2, L = 255, k1 = 0.01
        c2 = self.prm.extra.get("c2", 58.5225)   # (k2 L)^2, k2 = 0.03
        t = state.template
        mu0 = t.mean(dim=-2)
        mut = patch.mean(dim=-2)
        # population variances, as jnp.var
        v0 = t.var(dim=-2, correction=0)
        vt = patch.var(dim=-2, correction=0)
        cov = ((t - mu0[..., None, :]) * (patch - mut[..., None, :])).mean(
            dim=-2)
        ssim = ((2 * mu0 * mut + c1) * (2 * cov + c2)) / (
            (mu0 * mu0 + mut * mut + c1) * (v0 + vt + c2))
        return ssim.mean(dim=-1)

    def likelihood(self, state, patch):
        return torch.exp(-self.prm.likelihood_alpha
                         * (1.0 - self.f(state, patch)))


class SPSS(AM):
    """Sum of pixelwise structural similarity: the mean over pixels of
    (2 I0 It + c) / (I0^2 + It^2 + c)."""
    name = "spss"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        c = self.prm.extra.get("k", 0.01) * (self.prm.pix_max ** 2)
        t = state.template
        return ((2.0 * t * patch + c) / (t * t + patch * patch + c)).mean(
            dim=(-2, -1))

    def likelihood(self, state, patch):
        return torch.exp(-self.prm.likelihood_alpha
                         * (1.0 - self.f(state, patch)))
