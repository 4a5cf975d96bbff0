"""Dense-interpolation tap weights (port of
`mtf_tpu/ops/pallas/dense_sample.py:_weights_dense`, linear taps), used by
the plain form of the chain kernel. The cubic and blurred-tap (K4b) modes
are still to be ported (ROADMAP Queue 2)."""
from __future__ import annotations

import torch


def _weights_dense(t: torch.Tensor):
    """(phi(t), phi'(t)) of the linear kernel on tap offsets t = k - x
    (any shape): phi = max(0, 1 - |t|) and phi' = -sign(t) for |t| < 1,
    so phi' is 0 at t = 0 (an exactly integer coordinate)."""
    a = torch.abs(t)
    s = torch.sign(t)
    return (torch.clamp(1.0 - a, min=0.0),
            torch.where(a < 1.0, -s, torch.zeros_like(s)))
