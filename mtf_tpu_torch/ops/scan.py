"""Prefix sums in a fixed summation order (the integral images of TLD's
variance filter, RCT's rectangle sums and FragTrack's histograms).

`cumsum` adds in the order XLA gives `jnp.cumsum` on the CPU (its
reduce-window rewrite): the axis is cut into blocks of 16, each block is
summed from its start, one element at a time, and the blocks' totals are
scanned the same way and added to the next blocks. The order is that on
every device, so an integral image here equals the JAX package's bit for
bit: a float32 variance from an integral image of squares (values near
1e9) cancels to a few units, and TLD compares it with a threshold.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 16


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    nb = -(-n // _BLOCK)
    xp = F.pad(x, (0, nb * _BLOCK - n)).reshape(x.shape[:-1]
                                                 + (nb, _BLOCK))
    cols = [xp[..., 0]]
    for k in range(1, _BLOCK):
        cols.append(cols[-1] + xp[..., k])
    inb = torch.stack(cols, -1)                       # (..., nb, 16)
    if nb > 1:
        c = _scan_last(inb[..., -1])                  # inclusive totals
        carry = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)
        inb = inb + carry[..., None]
    return inb.reshape(x.shape[:-1] + (nb * _BLOCK,))[..., :n]


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum of `x` along `dim` in the order above."""
    return _scan_last(x.movedim(dim, -1)).movedim(-1, dim)


def cumsum2(img: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """Integral image: the prefix sum along dims[0] (rows), then along
    dims[1] (columns), as the JAX package's `cumsum(cumsum(img, 0), 1)`."""
    return cumsum(cumsum(img, dims[0]), dims[1])
