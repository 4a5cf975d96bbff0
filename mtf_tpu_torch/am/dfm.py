"""DFM: the feature-map appearance model (port of `mtf_tpu/am/dfm.py`),
over patches (..., N, C).

Two 3x3 convolutions with fixed seeded filters, each followed by
tanh(x / 255) * 255, map a patch on its (resy, resx) grid to F feature
channels; f is SSD on the feature maps over F. The filters are the JAX
package's draw (numpy `default_rng(dfm_seed)`), kept in the JAX HWIO
layout and turned to OIHW for `conv2d` (padding 1, the JAX SAME padding
of a 3x3 window); cuDNN's TF32 is off in the package, so the convolutions
run in float32. DFM needs the full grid.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mtf_tpu_torch.am.base import AM, AMState, PerDevice


def _default_filters(in_ch: int, features: tuple, seed: int) -> list:
    """The JAX package's filters, HWIO (3, 3, c_in, c_out) float32."""
    rng = np.random.default_rng(seed)
    params = []
    c = in_ch
    for f in features:
        w = rng.normal(0, 1.0 / np.sqrt(9 * c), (3, 3, c, f))
        params.append(w.astype(np.float32))
        c = f
    return params


class DFM(AM):
    """Feature-map SSD ('dfm' key)."""
    name = "dfm"

    def __init__(self, params=None, ilm=None):
        super().__init__(params, ilm)
        feats = tuple(self.prm.extra.get("dfm_features", (8, 16)))
        seed = int(self.prm.extra.get("dfm_seed", 0))
        self._filters = [PerDevice(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1)))
            for w in _default_filters(self.prm.n_channels, feats, seed)]

    def _features(self, patch: torch.Tensor) -> torch.Tensor:
        """(..., N, C) -> (..., N, F) feature maps on the same grid."""
        ry, rx = self.prm.resy, self.prm.resx
        lead = patch.shape[:-2]
        x = patch.reshape((-1, ry, rx, patch.shape[-1])).permute(0, 3, 1, 2)
        for w in self._filters:
            x = torch.tanh(F.conv2d(x, w.on(patch.device), padding=1)
                           / 255.0) * 255.0
        return x.permute(0, 2, 3, 1).reshape(lead + (ry * rx, x.shape[1]))

    def _init_extra(self, patch0):
        return (self._features(patch0),)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        f0 = state.extra[0]
        d = self._features(patch) - f0
        return -0.5 * (d * d).sum(dim=(-2, -1)) / f0.shape[-1]

    def likelihood(self, state, patch):
        f = self.f(state, patch)
        n = self.prm.resx * self.prm.resy
        return torch.exp(-self.prm.likelihood_alpha
                         * torch.sqrt(torch.clamp(-2.0 * f / n, min=0.0)))

    def dist_feat(self, patch):
        """The feature maps (..., N·F), n·F + f."""
        return self._features(patch).flatten(-2)
