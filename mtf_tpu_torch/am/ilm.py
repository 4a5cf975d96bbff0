"""Illumination models (port of `mtf_tpu/am/ilm.py`): GB, PGB and RBF.

Each is a map g(I, p) linear in its parameters, applied to the candidate
patch I (..., N, C) with parameters p (..., P) (leading dims broadcast;
`torch.func` calls them on one tracker too). Multiplicative terms are
(1 + a), so p = 0 is the identity. Their Jacobians in p come from
`torch.func` on the LK path, so only `apply` is written here.
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch.am.base import IlluminationModel, PerDevice


class GB(IlluminationModel):
    """Global gain and bias: g(I, p) = (1 + a) I + b * bias_scale."""
    name = "gb"
    n_params = 2

    def __init__(self, bias_scale: float = 1.0):
        self.bias_scale = bias_scale

    def apply(self, patch: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return ((1.0 + p[..., 0, None, None]) * patch
                + p[..., 1, None, None] * self.bias_scale)


class PGB(IlluminationModel):
    """A gain per sub-region of the (resy, resx) point grid (kx x ky
    regions) and a global bias."""
    name = "pgb"

    def __init__(self, resx: int, resy: int, sub_regions_x: int = 3,
                 sub_regions_y: int = 3, bias_scale: float = 1.0):
        self.resx, self.resy = resx, resy
        self.kx, self.ky = sub_regions_x, sub_regions_y
        self.n_params = self.kx * self.ky + 1
        self.bias_scale = bias_scale
        ys = np.minimum((np.arange(resy) * self.ky) // resy, self.ky - 1)
        xs = np.minimum((np.arange(resx) * self.kx) // resx, self.kx - 1)
        self._region = PerDevice(
            (ys[:, None] * self.kx + xs[None, :]).reshape(-1).astype(
                np.int64))                                  # (N,)

    def apply(self, patch: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        gains = 1.0 + p[..., :-1][..., self._region.on(p.device)]  # (..., N)
        return gains[..., None] * patch + p[..., -1, None, None] * \
            self.bias_scale


class RBF(IlluminationModel):
    """A gain surface of Gaussian radial basis functions on an
    n_ctrl_x x n_ctrl_y control grid over the patch, and a global bias."""
    name = "rbf"

    def __init__(self, resx: int, resy: int, n_ctrl_x: int = 3,
                 n_ctrl_y: int = 3, bias_scale: float = 1.0):
        self.n_params = n_ctrl_x * n_ctrl_y + 1
        self.bias_scale = bias_scale
        gx, gy = np.meshgrid(np.linspace(0, resx - 1, resx),
                             np.linspace(0, resy - 1, resy))
        pix = np.stack([gx.ravel(), gy.ravel()], -1)              # (N, 2)
        gcx, gcy = np.meshgrid(np.linspace(0, resx - 1, n_ctrl_x),
                               np.linspace(0, resy - 1, n_ctrl_y))
        ctrl = np.stack([gcx.ravel(), gcy.ravel()], -1)           # (K, 2)
        sigma = 0.5 * max(resx / n_ctrl_x, resy / n_ctrl_y)
        d2 = ((pix[:, None, :] - ctrl[None, :, :]) ** 2).sum(-1)
        self._phi = PerDevice(
            np.exp(-d2 / (2 * sigma * sigma)).astype(np.float32))  # (N, K)

    def apply(self, patch: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        gains = 1.0 + torch.matmul(self._phi.on(p.device),
                                   p[..., :-1, None])[..., 0]
        return gains[..., None] * patch + p[..., -1, None, None] * \
            self.bias_scale


ILM_REGISTRY = {"gb": GB, "pgb": PGB, "rbf": RBF}
