"""SSD-family appearance models (port of `mtf_tpu/am/ssd.py`): SSD, NSSD,
ZNCC and SAD, over patches (..., N, C)."""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState
from mtf_tpu_torch.ops.hist import _abs


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


class NSSD(SSD):
    """SSD on pixels remapped to [0, 1] by the pixel range; the template
    stays raw, so `grad_template` goes through the remap."""
    name = "nssd"

    def _norm(self, patch: torch.Tensor) -> torch.Tensor:
        return (patch - self.prm.pix_min) / (self.prm.pix_max
                                             - self.prm.pix_min)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        r = self._norm(patch) - self._norm(state.template)
        return -0.5 * (r * r).sum(dim=(-2, -1))


class ZNCC(SSD):
    """SSD on patches standardised per channel over the points (zero mean,
    unit population std, as `jnp.std`)."""
    name = "zncc"

    @staticmethod
    def _standardize(patch: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        mu = patch.mean(dim=-2, keepdim=True)
        sd = patch.std(dim=-2, keepdim=True, correction=0)
        return (patch - mu) / (sd + eps)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        r = self._standardize(patch) - self._standardize(state.template)
        return -0.5 * (r * r).sum(dim=(-2, -1))

    def dist_feat(self, patch: torch.Tensor) -> torch.Tensor:
        """The standardised patch (..., N·C), n·C + c."""
        return self._standardize(patch).flatten(-2)


class SAD(AM):
    """f = -sum |It - I0| per tracker; |.| differentiates to +1 at 0, as
    `jnp.abs` does. The term 0 r^2 adds nothing to f or its derivatives;
    it keeps a Hessian-vector product's tangent a function of the patch,
    without which `torch.func.vmap` over `jvp` of the gradient (the
    Gauss-Newton Hessian) fails on a piecewise-linear f."""
    name = "sad"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        r = patch - state.template
        return -(_abs(r) + 0.0 * r * r).sum(dim=(-2, -1))
