"""Cubic B-spline Parzen histograms (port of `mtf_tpu/ops/hist.py`).

Every pixel's fractional bin memberships are a dense (..., N, n_bins)
weight matrix, so a joint histogram is one float32 matmul and every
quantity stays differentiable in the pixel values through the spline.
Leading batch dims are carried through.
"""
from __future__ import annotations

import torch


def _abs(t: torch.Tensor) -> torch.Tensor:
    """|t| with derivative +1 at 0, as `jnp.abs` has it (`torch.abs` has
    0): the spline's inner piece 4 - 6 t^2 + 3 |t|^3 then keeps its second
    derivative -12 at t = 0, a pixel on a bin centre (a saturated one, for
    instance), which 0 there would drop."""
    return torch.where(t >= 0, t, -t)


def bspl3(t: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline window, support |t| < 2."""
    a = _abs(t)
    inner = (4.0 - 6.0 * a * a + 3.0 * a * a * a) / 6.0
    outer = (2.0 - a) ** 3 / 6.0
    zero = torch.zeros_like(a)
    return torch.where(a <= 1.0, inner, torch.where(a < 2.0, outer, zero))


def bspl3_grad(t: torch.Tensor) -> torch.Tensor:
    """d bspl3 / dt."""
    a = _abs(t)
    s = torch.sign(t)
    inner = s * (-12.0 * a + 9.0 * a * a) / 6.0
    outer = s * (-3.0 * (2.0 - a) ** 2) / 6.0
    zero = torch.zeros_like(a)
    return torch.where(a <= 1.0, inner, torch.where(a < 2.0, outer, zero))


def cum_bspl3(t: torch.Tensor) -> torch.Tensor:
    """Cumulative B-spline, the integral of bspl3 from -2 to t: a smooth
    step from 0 (t <= -2) to 1 (t >= 2)."""
    t = torch.clamp(t, -2.0, 2.0)
    seg_lo = (t + 2.0) ** 4 / 24.0
    seg_mid_neg = 1.0 / 24.0 + ((4.0 * t - 2.0 * t ** 3 - 0.75 * t ** 4)
                                - (-4.0 + 2.0 - 0.75)) / 6.0
    seg_mid_pos = 0.5 + (4.0 * t - 2.0 * t ** 3 + 0.75 * t ** 4) / 6.0
    seg_hi = 1.0 - (2.0 - t) ** 4 / 24.0
    return torch.where(
        t <= -1.0, seg_lo,
        torch.where(t <= 0.0, seg_mid_neg,
                    torch.where(t <= 1.0, seg_mid_pos, seg_hi)))


def to_bin_coords(pix: torch.Tensor, n_bins: int, pix_min: float = 0.0,
                  pix_max: float = 255.0,
                  pre_seed: float = 1.0) -> torch.Tensor:
    """Affine map of pixel values into Parzen bin coordinates
    [pre_seed, n_bins - 1 - pre_seed]."""
    lo, hi = pre_seed, n_bins - 1.0 - pre_seed
    return (pix - pix_min) / (pix_max - pix_min) * (hi - lo) + lo


def _bins(z: torch.Tensor, n_bins: int) -> torch.Tensor:
    return torch.arange(n_bins, dtype=z.dtype, device=z.device)


def bspl_weights(z: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Parzen memberships (..., N, n_bins): w[i, b] = bspl3(z_i - b)."""
    return bspl3(z[..., None] - _bins(z, n_bins))


def cum_bspl_weights(z: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Cumulative (survival) memberships (..., N, n_bins):
    w[i, b] = 1 - cum_bspl3(b - z_i), a soft indicator of pixel > bin."""
    return 1.0 - cum_bspl3(_bins(z, n_bins) - z[..., None])


def marginal_hist(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalised marginal histogram (..., n_bins) from (..., N, n_bins)."""
    h = w.mean(dim=-2)
    return h / (h.sum(dim=-1, keepdim=True) + eps)


def joint_hist(w0: torch.Tensor, wt: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """Normalised joint histogram (..., n_bins, n_bins) = w0^T wt, one
    float32 matmul (TF32 is off in the package)."""
    j = torch.matmul(w0.transpose(-1, -2), wt)
    return j / (j.sum(dim=(-2, -1), keepdim=True) + eps)


def mutual_information(j: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """MI (...,) from normalised joint histograms (..., n_bins, n_bins)."""
    p0 = j.sum(dim=-1)
    pt = j.sum(dim=-2)
    denom = p0[..., :, None] * pt[..., None, :]
    return (j * (torch.log(j + eps) - torch.log(denom + eps))).sum(
        dim=(-2, -1))


def entropy(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return -(p * torch.log(p + eps)).sum(dim=-1)
