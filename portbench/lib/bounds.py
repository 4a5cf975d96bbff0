"""The least time of one kernel launch on the card: a frozen copy of the
byte and operation counts of `chip_smoke._bound_ms` (the chain kernel)
and `chip_smoke._k5_bound` (the grid flow, K5), so that a later change to
the program cannot move the yardstick.

Peaks of one NVIDIA H100 SXM (data sheet, dense rates): 3.35 TB/s of
HBM, 67 TFLOP/s in float32 outside the tensor cores. A launch's least
time is the larger of its bytes over the first and its operations over
the second; each input byte is counted once and each output byte once."""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# K5: operations per point and iteration by tap kind
K5_FLOPS_PER_PT_ITER = {"linear": 60, "cubic": 230, "cubic_bspl": 230}


def _least(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _taps(kind: str, blur: int = 0):
    """(clamp lo, clamp hi, taps per axis, first tap offset) of a kind,
    widened by the blur radius r = blur - 1."""
    r = blur - 1 if blur > 1 else 0
    lo, hi, taps, first = ((0.001, 1.001, 2, 0) if kind == "linear"
                           else (1.001, 2.001, 4, -1))
    return lo + r, hi + r, taps + 2 * r, first - r


def chain_bound_ms(window, M0, gens, ph, templ, j0=None, am="ssd",
                   kind="linear", blur=0, **_):
    """One chain-kernel launch (`lk_fused_chain(window, M0, gens, ph,
    templ, j0=..., am=..., kind=...)`): the window pixels its points' taps
    cover (a window shared by every tracker counted once over all of
    them) in each of its C channels, the warps, points, template and J0
    read once; the outputs written once. Per point: projection and
    reciprocal ~20, warp Jacobian 24 per state dim, tap weights (linear
    ~8, cubic 112; blurred: 2 x taps weights over 2r + 1 taps of ~6 /
    ~14), ESM mean 2 per dim; per channel: the value and derivatives from
    the taps (linear ~20, cubic 88; blurred 4 taps^2 + 6 taps), Jm 3 per
    dim, the residual, 2 per accumulator. Returns (ms, "bytes" |
    "operations", bytes, flops)."""
    esm = j0 is not None
    win = window
    b, hc, wc = win.shape[0], win.shape[-2], win.shape[-1]
    c = win.shape[1] if win.dim() == 4 else 1
    n = ph.shape[-1]
    s = gens.shape[0]
    r = blur - 1 if blur > 1 else 0
    q = M0 @ ph
    lo, hi, taps, first = _taps(kind, blur)
    x = torch.clamp(q[:, 0] / q[:, 2], lo, wc - hi).floor().long() + first
    y = torch.clamp(q[:, 1] / q[:, 2], lo, hc - hi).floor().long() + first
    i0 = y * wc + x
    idx = torch.cat([i0 + (rr * wc + j) for rr in range(taps)
                     for j in range(taps)], dim=-1)
    if win.shape[0] > 1 and win.stride(0) == 0:
        cover = torch.zeros(hc * wc, dtype=torch.bool, device=win.device)
        cover.scatter_(0, idx.flatten(), True)
    else:
        cover = torch.zeros((b, hc * wc), dtype=torch.bool,
                            device=win.device)
        cover.scatter_(1, idx, True)
    n_out = s + s * s + ((2 * s + 5) if am == "ncc" else 0)
    nbytes = 4 * (c * int(cover.sum()) + b * (9 + 3 * n + c * n)
                  + gens.numel() + (b * s * n if esm else 0) + b * c * n
                  + b * n_out)
    n_acc = s + s * (s + 1) // 2 + ((2 * s + 5) if am == "ncc" else 0)
    if r:
        weights = 2 * taps * (2 * r + 1) * (6 if kind == "linear" else 14)
        sample = 4 * taps * taps + 6 * taps
    else:
        weights, sample = (8, 20) if kind == "linear" else (112, 88)
    per_pt = (20 + 24 * s + weights + (2 * s if esm else 0)
              + c * (sample + 3 * s + 1 + 2 * n_acc))
    return _least(nbytes, b * n * per_pt)


def k5_bound_ms(disp, win, pts, templ, scale, n, n_iters, zncc=True,
                kind="linear", **_):
    """One grid-flow launch (`grid_flow(win, pts, templ, scale, n,
    n_iters, zncc=..., kind=...)` returning `disp`): the window pixels the
    taps of every point cover (2x2 linear, 4x4 cubic) at the start and at
    the end of the level, each counted once; points 8 B and template 4 B
    per point; the scale; disp written; K5_FLOPS_PER_PT_ITER per point
    and iteration. Returns (ms, "bytes" | "operations", bytes, flops)."""
    b, hc, wc = win.shape
    pn = pts.shape[-1]
    lo, hi, taps, first = _taps(kind)
    cover = torch.zeros((b, hc * wc), dtype=torch.bool, device=win.device)
    for d in (torch.zeros_like(disp), disp):
        off = (d * scale[:, None, None]).repeat_interleave(n, dim=1)
        x = torch.clamp(pts[:, 0] + off[..., 0], lo, wc - hi)
        y = torch.clamp(pts[:, 1] + off[..., 1], lo, hc - hi)
        i0 = (y.floor().long() + first) * wc + x.floor().long() + first
        cover.scatter_(1, torch.cat([i0 + (r * wc + j) for r in range(taps)
                                     for j in range(taps)], dim=-1), True)
    nbytes = 4 * int(cover.sum()) + b * (12 * pn + 4 + 8 * (pn // n))
    return _least(nbytes, K5_FLOPS_PER_PT_ITER[kind] * b * pn * n_iters)
