"""Gaussian image pyramids for `PyramidalSM` (port of
`mtf_tpu/utils/pyramid.py`): a 5x5 binomial blur and stride-2
subsampling, zero padding 2, on (H, W) or (H, W, C) images, or on
per-tracker images (B, H, W, C)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_KERNEL_1D = (1.0, 4.0, 6.0, 4.0, 1.0)


def gaussian_downsample(img: torch.Tensor) -> torch.Tensor:
    """(H, W[, C]) -> (ceil(H/2), ceil(W/2)[, C]), each channel blurred by
    the binomial [1, 4, 6, 4, 1] / 16 in both axes; per-tracker images
    (B, H, W, C) each alike."""
    gray = img.dim() == 2
    multi = img.dim() == 4
    x = (img.permute(0, 3, 1, 2) if multi else img[None, None] if gray
         else img.permute(2, 0, 1)[None])
    c = x.shape[1]
    k1 = torch.tensor(_KERNEL_1D, dtype=img.dtype, device=img.device) / 16.0
    kern = (k1[:, None] * k1[None, :]).expand(c, 1, 5, 5)
    y = F.conv2d(x, kern, stride=2, padding=2, groups=c)
    if multi:
        return y.permute(0, 2, 3, 1)
    return y[0, 0] if gray else y[0].permute(1, 2, 0)


def build_pyramid(img: torch.Tensor, n_levels: int) -> list:
    """[level 0 (the image), level 1 (half), ...]."""
    out = [img]
    for _ in range(n_levels - 1):
        out.append(gaussian_downsample(out[-1]))
    return out
