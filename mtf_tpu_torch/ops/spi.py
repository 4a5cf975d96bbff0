"""Selective Pixel Integration (SPI) masks (port of `mtf_tpu/ops/spi.py`):
per-pixel weights in [0, 1] that gate which template pixels add to the
gradient and Hessian of a registration step, over B trackers. Each mask
is a soft threshold, sigmoid(soft (criterion - thresh) / thresh):

  * pix_diff: the mean absolute difference of patch and template over
    the channels, relative to the template's largest magnitude, below
    `thresh`;
  * gradient: the patch's gradient magnitude on its grid, relative to its
    largest, above `thresh`;
  * gftt: the smaller eigenvalue of the 3x3 box-filtered structure tensor
    (the good-features-to-track criterion), relative to its largest,
    above `thresh`.

Patches and templates are (B, N, C) on the row-major (resy, resx) grid;
masks are (B, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pix_diff_mask(template: torch.Tensor, patch: torch.Tensor,
                  thresh: float = 0.2, soft: float = 10.0) -> torch.Tensor:
    t = template.flatten(2)
    p = patch.flatten(2)
    scale = torch.clamp(t.abs().amax((-2, -1)), min=1e-6)[:, None]
    rel = (p - t).abs().mean(-1) / scale
    return torch.sigmoid(soft * (thresh - rel) / thresh)


def _patch_gradients(patch: torch.Tensor, resy: int, resx: int):
    """Central differences (one-sided at the edges) of (B, N, C) patches
    on their (resy, resx) grid -> gx, gy (B, resy, resx, C)."""
    img = patch.reshape(patch.shape[0], resy, resx, -1)
    return torch.gradient(img, dim=2)[0], torch.gradient(img, dim=1)[0]


def gradient_mask(patch: torch.Tensor, resy: int, resx: int,
                  thresh: float = 0.05, soft: float = 10.0) -> torch.Tensor:
    gx, gy = _patch_gradients(patch, resy, resx)
    mag = torch.sqrt((gx * gx + gy * gy).sum(-1)).flatten(1)
    scale = torch.clamp(mag.amax(-1, keepdim=True), min=1e-6)
    return torch.sigmoid(soft * (mag / scale - thresh) / max(thresh, 1e-6))


def _box(a: torch.Tensor, window: int) -> torch.Tensor:
    """'same' box filter of (B, H, W) with zero fill (`convolve2d`)."""
    r = window // 2
    h, w = a.shape[-2:]
    f = F.pad(a, (r, window - 1 - r, r, window - 1 - r))
    s = sum(f[:, i:i + h, j:j + w] for i in range(window)
            for j in range(window))
    return s / (window * window)


def gftt_mask(patch: torch.Tensor, resy: int, resx: int,
              thresh: float = 0.01, window: int = 3,
              soft: float = 10.0) -> torch.Tensor:
    gx, gy = _patch_gradients(patch, resy, resx)
    gx, gy = gx.sum(-1), gy.sum(-1)
    xx, xy, yy = (_box(v, window) for v in (gx * gx, gx * gy, gy * gy))
    tr = xx + yy
    det = xx * yy - xy * xy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    min_eig = (tr / 2 - disc).flatten(1)
    scale = torch.clamp(min_eig.amax(-1, keepdim=True), min=1e-6)
    return torch.sigmoid(
        soft * (min_eig / scale - thresh) / max(thresh, 1e-6))


SPI_KINDS = ("pix_diff", "pixdiff", "diff", "gradient", "grad", "gftt")


SPI_REGISTRY = {
    "pix_diff": pix_diff_mask,
    "gradient": gradient_mask,
    "gftt": gftt_mask,
}


def compute_spi_mask(kind: str, template: torch.Tensor, patch: torch.Tensor,
                     resy: int, resx: int, thresh: float) -> torch.Tensor:
    """Dispatch on the reference's spi_type keys -> (B, N)."""
    k = kind.lower()
    if k in ("pix_diff", "pixdiff", "diff"):
        return pix_diff_mask(template, patch, thresh)
    if k in ("gradient", "grad"):
        return gradient_mask(patch, resy, resx, thresh)
    if k == "gftt":
        return gftt_mask(patch, resy, resx, thresh)
    raise ValueError(f"unknown SPI type {kind!r}")
