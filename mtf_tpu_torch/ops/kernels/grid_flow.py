"""Grid flow: every joint 2-DOF LK iteration of one pyramid level, for all
patches of B grid trackers in one call (port of
`mtf_tpu/ops/pallas/grid_flow.py:grid_flow_fused`, the K5 kernel).

Per tracker b, patch p and iteration, with disp (2,) in template units
starting at 0:
  * window-px offset = disp * scale; each of the patch's n points is
    moved by it and clamped to [0.001, size - 1.001] of the window;
  * val, dx, dy: the dense-convention linear sample (derivative 0 along
    an axis at an exactly integer coordinate);
  * with `zncc`, val is standardised per patch in two passes: the mean,
    then Σ(v - μ)²/n, inv = 1/(√var + 1e-6), val := (val - μ) * inv;
  * r = val - templ, (Jx, Jy) = (dx, dy) * scale;
  * the sums [ΣJxJx + 1e-6, ΣJxJy, ΣJyJy + 1e-6, ΣJx r, ΣJy r] give the
    damped 2x2 system, solved in closed form with the JAX package's
    determinant guard (`ops/linalg.py:solve2x2`); disp -= d.

Two levels, one contract:
  * `grid_flow_ref`: plain PyTorch;
  * `grid_flow`: CPU tensors take the plain form, CUDA tensors launch the
    CUDA kernel `csrc/grid_flow.cu` (one launch runs all `n_iters`
    iterations); no fallback between them. `grid_flow.launches` counts
    kernel launches.

Not carried over from the TPU kernel, being layout artifacts: the bf16
window cast, the iota block-indicator (E-matrix) reductions, the point
tiling (`_grid_tiles`) and the 80-row y-bands with their in-band mask.
Without bands every point is live, which is the semantics of the JAX
package's XLA path (`sm/grid.py:_track_patches_mm`) that the TPU kernel's
docstring states it shares.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.linalg import solve2x2

N_MAX = 1024        # points per patch the CUDA kernel takes (32 per lane)


def grid_flow_ref(win: torch.Tensor, pts: torch.Tensor, templ: torch.Tensor,
                  scale: torch.Tensor, n: int, n_iters: int,
                  zncc: bool = True) -> torch.Tensor:
    """Plain form. win (B, Hc, Wc), pts (B, 2, P*n) window px,
    patch-major (patch p owns columns [p*n, (p+1)*n)), templ (B, P*n),
    scale (B,) template units -> window px -> disp (B, P, 2) in template
    units."""
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
        val, dx, dy = interp.sample_windows(win, x, y, need_grad=True)
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


def _check(win, pts, templ, scale, n, n_iters):
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
    if win.dim() != 3 or win.shape[1] < 2 or win.shape[2] < 2:
        raise ValueError(f"grid_flow: win must be (B, Hc, Wc) with Hc, Wc "
                         f">= 2, got {tuple(win.shape)}")
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


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    fn = _build.load("grid_flow").lib.grid_flow_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_flow(win: torch.Tensor, pts: torch.Tensor, templ: torch.Tensor,
              scale: torch.Tensor, n: int, n_iters: int,
              zncc: bool = True) -> torch.Tensor:
    """`n_iters` joint grid-flow iterations (contract of `grid_flow_ref`)
    -> disp (B, P, 2) in template units. CPU tensors run the plain form;
    CUDA tensors launch the CUDA kernel on the current stream."""
    if win.device.type == "cpu":
        return grid_flow_ref(win, pts, templ, scale, n, n_iters, zncc)
    if win.device.type != "cuda":
        raise ValueError(f"grid_flow: unsupported device {win.device}")
    _check(win, pts, templ, scale, n, n_iters)
    b, hc, wc = win.shape
    p = templ.shape[-1] // n
    disp = torch.empty((b, p, 2), dtype=torch.float32, device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(win.data_ptr(), pts.data_ptr(), templ.data_ptr(),
                           scale.data_ptr(), disp.data_ptr(), b, hc, wc, p,
                           n, int(n_iters), int(zncc), stream)
    if err != 0:
        raise RuntimeError(f"grid_flow: kernel launch failed with CUDA error "
                           f"{err}")
    grid_flow.launches += 1
    return disp


grid_flow.launches = 0
