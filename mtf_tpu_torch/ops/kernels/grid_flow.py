"""Grid flow: every joint 2-DOF LK iteration of one pyramid level, for all
patches of B grid trackers in one call (port of
`mtf_tpu/ops/pallas/grid_flow.py:grid_flow_fused`: the K5 kernel with
linear taps, K5c with the cubic kinds).

Per tracker b, patch p and iteration, with disp (2,) in template units
starting at 0:
  * window-px offset = disp * scale; each of the patch's n points is
    moved by it and clamped to [0.001, size - 1.001] of the window for
    `kind="linear"`, to [1.001, size - 2.001] for the 4x4 taps of
    "cubic" (Catmull-Rom) and "cubic_bspl" (cubic B-spline);
  * val, dx, dy: the dense-convention sample of `kind`
    (`interp.sample_windows`; linear: derivative 0 along an axis at an
    exactly integer coordinate; cubic: each tap row summed first);
  * with `zncc`, val is standardised per patch in two passes: the mean,
    then Σ(v - μ)²/n, inv = 1/(√var + 1e-6), val := (val - μ) * inv;
  * r = val - templ, (Jx, Jy) = (dx, dy) * scale;
  * the sums [ΣJxJx + 1e-6, ΣJxJy, ΣJyJy + 1e-6, ΣJx r, ΣJy r] give the
    damped 2x2 system, solved in closed form with the JAX package's
    determinant guard (`ops/linalg.py:solve2x2`); disp -= d.

With `bf16` (the bfloat16-operand flag of `interp_bf16`, the semantics of
the JAX package's `_track_patches_mm` with `compute_dtype=bfloat16`) the
tap and derivative weights are rounded to bfloat16; the window holds
values the caller rounded; every product and sum stays float32.

Two levels, one contract:
  * `grid_flow_ref`: plain PyTorch;
  * `grid_flow`: CPU tensors take the plain form, CUDA tensors launch the
    CUDA kernel `csrc/grid_flow.cu` (one launch runs all `n_iters`
    iterations) at the lanes per patch and points per lane that
    `layout` picks; no fallback between them. `grid_flow.launches`
    counts kernel launches per tap kind ("linear", ...; "<kind>+bf16"
    with the flag).

Not carried over from the TPU kernel, being layout artifacts: the iota
block-indicator (E-matrix) reductions, the point tiling (`_grid_tiles`)
and the 80-row y-bands with their in-band mask. Without bands every point is live, which is the semantics of the JAX
package's XLA path (`sm/grid.py:_track_patches_mm`) that the TPU kernel's
docstring states it shares.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels.dense_sample import KINDS
from mtf_tpu_torch.ops.linalg import solve2x2

N_MAX = 1024        # points per patch the CUDA kernel takes (32 per lane)
MAX_LANES = 32      # threads per patch: a patch never straddles a warp
# points per lane of the kernel's instantiations, each with every tap kind
POINTS_PER_LANE = (1, 2, 4, 8, 16, 32)
INSTANTIATIONS = tuple((k, kind) for kind in KINDS for k in POINTS_PER_LANE)
# points a lane takes: 8 (the most a lane keeps in registers,
# `csrc/grid_flow.cu`) where a patch of more than 16 points runs several
# iterations, so that the butterfly and the 2x2 solve that every lane of a
# patch repeats are shared among the most points; 4 where a launch runs
# one iteration or its patches are small, where more lanes in flight
# cover the loads' latency better (a sweep of every layout on the card,
# PERF.md §6: Median Flow's n = 64 x 20 iterations 8 x 8 lanes x
# points, rklt's n = 16 x 8 iterations 4 x 4, n = 64 x 1 iteration 16 x 4)
PER_LANE, PER_LANE_SHORT = 8, 4


def layout(n: int, n_iters: int) -> tuple[int, int]:
    """(lanes, points per lane) of the CUDA kernel for patches of n points
    run `n_iters` iterations: the fewest lanes, a power of two up to
    MAX_LANES, that take the n points at PER_LANE each (PER_LANE_SHORT for
    one iteration or n <= 16), then the fewest points per lane (a power of
    two) that cover n."""
    if not 1 <= n <= N_MAX:
        raise ValueError(f"grid_flow: n = {n} outside 1..{N_MAX}")
    per = PER_LANE if n > 16 and n_iters > 1 else PER_LANE_SHORT
    lanes = 1
    while lanes < MAX_LANES and lanes * per < n:
        lanes *= 2
    per_lane = 1
    while lanes * per_lane < n:
        per_lane *= 2
    return lanes, per_lane


def _kind_check(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"grid_flow: unknown tap kind {kind!r}; known: "
                         f"{KINDS}")


def grid_flow_ref(win: torch.Tensor, pts: torch.Tensor, templ: torch.Tensor,
                  scale: torch.Tensor, n: int, n_iters: int,
                  zncc: bool = True, kind: str = "linear",
                  bf16: bool = False) -> torch.Tensor:
    """Plain form. win (B, Hc, Wc), pts (B, 2, P*n) window px,
    patch-major (patch p owns columns [p*n, (p+1)*n)), templ (B, P*n),
    scale (B,) template units -> window px -> disp (B, P, 2) in template
    units; `kind` the taps (linear, cubic, cubic_bspl); `bf16` the
    bfloat16 weights (and window values)."""
    _kind_check(kind)
    b, pn = templ.shape
    p = pn // n
    px = pts[:, 0].reshape(b, p, n)
    py = pts[:, 1].reshape(b, p, n)
    t = templ.reshape(b, p, n)
    s = scale[:, None, None]
    disp = torch.zeros((b, p, 2), dtype=win.dtype, device=win.device)
    for _ in range(n_iters):
        off = disp * s                                      # window px
        x = (px + off[..., 0:1]).reshape(b, pn)
        y = (py + off[..., 1:2]).reshape(b, pn)
        val, dx, dy = interp.sample_windows(win, x, y, need_grad=True,
                                            kind=kind, bf16=bf16)
        v = val.reshape(b, p, n)
        if zncc:
            c = v - v.sum(-1, keepdim=True) / n
            inv = 1.0 / (torch.sqrt((c * c).sum(-1, keepdim=True) / n)
                         + 1e-6)
            v = c * inv
        r = v - t
        jx = dx.reshape(b, p, n) * s
        jy = dy.reshape(b, p, n) * s
        hxy = (jx * jy).sum(-1)
        H = torch.stack([torch.stack([(jx * jx).sum(-1) + 1e-6, hxy], -1),
                         torch.stack([hxy, (jy * jy).sum(-1) + 1e-6], -1)],
                        -2)
        g = torch.stack([(jx * r).sum(-1), (jy * r).sum(-1)], -1)
        disp = disp - solve2x2(H, g)
    return disp


def _check(win, pts, templ, scale, n, n_iters, kind):
    dev = win.device
    for name, t in (("win", win), ("pts", pts), ("templ", templ),
                    ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"grid_flow: {name} on {t.device}, win on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"grid_flow: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"grid_flow: {name} must be contiguous")
    side = 2 if kind == "linear" else 4      # one tap span
    if win.dim() != 3 or win.shape[1] < side or win.shape[2] < side:
        raise ValueError(f"grid_flow: win must be (B, Hc, Wc) with Hc, Wc "
                         f">= {side} for {kind} taps, got "
                         f"{tuple(win.shape)}")
    b, pn = win.shape[0], templ.shape[-1]
    if not 1 <= n <= N_MAX or pn % n or pn == 0 or b < 1:
        raise ValueError(f"grid_flow: need 1 <= n <= {N_MAX} dividing the "
                         f"{pn} points of B = {b} trackers, got n = {n}")
    if n_iters < 0:
        raise ValueError(f"grid_flow: n_iters must be >= 0, got {n_iters}")
    want = {"pts": (pts, (b, 2, pn)), "templ": (templ, (b, pn)),
            "scale": (scale, (b,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"grid_flow: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def build_defines(bf16: bool = False) -> dict | None:
    """The defines of the kernel's library: the bfloat16-operand flag is
    a library of its own (`-DGF_BF16=1`)."""
    return {"GF_BF16": 1} if bf16 else None


@functools.cache
def _kernel_fn(bf16: bool = False):
    """The kernel's C entry point (with the flag or not), built and bound
    on first use."""
    fn = _build.load("grid_flow", build_defines(bf16)).lib.grid_flow_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(win: torch.Tensor, pts: torch.Tensor, templ: torch.Tensor,
           scale: torch.Tensor, n: int, n_iters: int, zncc: bool,
           kind: str, lanes: int, per_lane: int,
           bf16: bool = False) -> torch.Tensor:
    """One CUDA launch at a given layout (`layout` picks it for
    `grid_flow`; a timing sweep may pass any other): checked CUDA
    operands -> disp (B, P, 2). Counts nothing."""
    b, hc, wc = win.shape
    p = templ.shape[-1] // n
    disp = torch.empty((b, p, 2), dtype=torch.float32, device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(bf16)(win.data_ptr(), pts.data_ptr(),
                               templ.data_ptr(), scale.data_ptr(),
                               disp.data_ptr(), b, hc, wc, p, n,
                               int(n_iters), int(zncc), KINDS.index(kind),
                               lanes, per_lane, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"grid_flow: kernel launch failed with CUDA error "
                           f"{err} (layout {lanes} lanes x {per_lane})")
    return disp


def grid_flow(win: torch.Tensor, pts: torch.Tensor, templ: torch.Tensor,
              scale: torch.Tensor, n: int, n_iters: int,
              zncc: bool = True, kind: str = "linear",
              bf16: bool = False) -> torch.Tensor:
    """`n_iters` joint grid-flow iterations (contract of `grid_flow_ref`)
    -> disp (B, P, 2) in template units. CPU tensors run the plain form;
    CUDA tensors launch the CUDA kernel on the current stream (K5 for
    linear taps, K5c for the cubic kinds) at `layout(n, n_iters)`."""
    _kind_check(kind)
    if win.device.type == "cpu":
        return grid_flow_ref(win, pts, templ, scale, n, n_iters, zncc, kind,
                             bf16)
    if win.device.type != "cuda":
        raise ValueError(f"grid_flow: unsupported device {win.device}")
    _check(win, pts, templ, scale, n, n_iters, kind)
    disp = launch(win, pts, templ, scale, n, n_iters, zncc, kind,
                  *layout(n, n_iters), bf16=bf16)
    grid_flow.launches[kind + ("+bf16" if bf16 else "")] += 1
    return disp


grid_flow.launches = dict.fromkeys(KINDS + tuple(k + "+bf16" for k in KINDS),
                                   0)
