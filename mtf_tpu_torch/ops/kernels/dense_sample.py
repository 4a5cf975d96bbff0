"""Dense-interpolation tap weights (port of
`mtf_tpu/ops/pallas/dense_sample.py:_weights_dense`): linear, Catmull-Rom
(`cubic`) and cubic B-spline (`cubic_bspl`) taps, used by the plain form
of the chain kernel and by the gather-form samplers of `ops/interp.py`.
The blurred-tap mode (K4b) is still to be ported (ROADMAP Queue 2)."""
from __future__ import annotations

import torch

KINDS = ("linear", "cubic", "cubic_bspl")


def _weights_dense(t: torch.Tensor, kind: str = "linear"):
    """(phi(t), phi'(t)) on tap offsets t = k - x (any shape), compact
    support: linear |t| < 1, the cubics |t| < 2. The linear phi' is
    -sign(t) for |t| < 1, so it is 0 at t = 0 (an exactly integer
    coordinate); the cubic phi' is continuous (-0.5 at |t| = 1 from both
    sides for Catmull-Rom)."""
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
        w_out = -(u * u * u) / 6.0
        d_in = 1.5 * a2 - 2.0 * a
        d_out = -0.5 * (u * u)
    else:
        raise ValueError(f"unknown dense kind {kind!r}; known: {KINDS}")
    inner, outer = a < 1.0, a < 2.0
    w = torch.where(inner, w_in, torch.where(outer, w_out, zero))
    dphi = torch.where(inner, d_in, torch.where(outer, d_out, zero)) * s
    return w, dphi
