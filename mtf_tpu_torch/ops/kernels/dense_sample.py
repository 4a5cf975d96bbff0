"""Dense-interpolation tap weights (port of
`mtf_tpu/ops/pallas/dense_sample.py`): linear, Catmull-Rom (`cubic`) and
cubic B-spline (`cubic_bspl`) taps, and their binomial-blurred form, used
by the plain forms of the LK kernels and by the gather-form samplers of
`ops/interp.py`."""
from __future__ import annotations

import numpy as np
import torch

KINDS = ("linear", "cubic", "cubic_bspl")


def _binomial_taps(stride: int) -> np.ndarray:
    """Binomial low-pass taps (2·stride - 1 of them, sigma ~ stride / 2)
    of a stride-decimated phase, float32 from float64."""
    k = np.array([1.0], np.float64)
    for _ in range(2 * (stride - 1)):
        k = np.convolve(k, [0.5, 0.5])
    return k.astype(np.float32)


def blur_radius(blur: int) -> int:
    """Radius r of the binomial taps of `blur` (0 for blur 0 or 1): the
    blurred kernel reaches r more taps on each side."""
    return blur - 1 if blur > 1 else 0


def _weights_dense(t: torch.Tensor, kind: str = "linear", blur: int = 0):
    """(phi(t), phi'(t)) on tap offsets t = k - x (any shape), compact
    support: linear |t| < 1, the cubics |t| < 2. The linear phi' is
    -sign(t) for |t| < 1, so it is 0 at t = 0 (an exactly integer
    coordinate); the cubic phi' is continuous (-0.5 at |t| = 1 from both
    sides for Catmull-Rom).

    `blur` > 1 gives the binomial-convolved kernel sum_i c_i phi(t - (i - r))
    over the 2·blur - 1 taps c of `_binomial_taps(blur)`: sampling the raw
    image with these taps equals sampling the binomially blurred image with
    plain taps (convolution commutes). The support grows by r = blur - 1
    on each side."""
    if blur > 1:
        taps = _binomial_taps(blur)
        r = blur_radius(blur)
        w = d = 0.0
        for i, c in enumerate(taps):
            wi, di = _weights_dense(t - (i - r), kind)
            w = w + float(c) * wi
            d = d + float(c) * di
        return w, d
    a = torch.abs(t)
    s = torch.sign(t)
    zero = torch.zeros_like(a)
    if kind == "linear":
        return torch.clamp(1.0 - a, min=0.0), torch.where(a < 1.0, -s, zero)
    a2, a3 = a * a, a * a * a
    if kind == "cubic":
        w_in = 1.5 * a3 - 2.5 * a2 + 1.0
        w_out = -0.5 * a3 + 2.5 * a2 - 4.0 * a + 2.0
        d_in = 4.5 * a2 - 5.0 * a
        d_out = -1.5 * a2 + 5.0 * a - 4.0
    elif kind == "cubic_bspl":
        u = a - 2.0
        w_in = 0.5 * a3 - a2 + 2.0 / 3.0
        # times the float32 reciprocal (what PyTorch's CUDA division by a
        # scalar computes), on every device alike
        w_out = -(u * u * u) * (1.0 / 6.0)
        d_in = 1.5 * a2 - 2.0 * a
        d_out = -0.5 * (u * u)
    else:
        raise ValueError(f"unknown dense kind {kind!r}; known: {KINDS}")
    inner, outer = a < 1.0, a < 2.0
    w = torch.where(inner, w_in, torch.where(outer, w_out, zero))
    dphi = torch.where(inner, d_in, torch.where(outer, d_out, zero)) * s
    return w, dphi
