"""Chain-fused LK iteration, SSD mode (port of
`mtf_tpu/ops/pallas/lk_fused.py:lk_fused_chain`).

One call is one Gauss-Newton iteration for B trackers: project the
homogeneous base points through the window warp M0, form the
quotient-rule warp Jacobian, sample the window with the dense linear
conventions, and reduce the SSD gradient g = J^T (templ - val) and
J^T J. Two forms with one contract:

  * `lk_fused_chain_ref`: plain PyTorch, the dense tap-weight math of the
    TPU kernel (`_weights_dense`) with full-float32 contractions;
  * the CUDA kernel `csrc/lk_fused_chain.cu`, launched by
    `lk_fused_chain` for CUDA tensors (see the source for its design).

`lk_fused_chain` dispatches on the tensors' device: CPU tensors take the
plain form, CUDA tensors the kernel; there is no fallback between them.
`lk_fused_chain.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels.dense_sample import _weights_dense

N_STATE = 8


def lk_fused_chain_ref(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor):
    """Plain form. window (B, Hc, Wc), M0 (B, 3, 3), gens (S, 3, 3),
    ph (B, 3, N), templ (B, N) -> val (B, N), g (B, S), JtJ (B, S, S)."""
    hc, wc = window.shape[-2:]
    # The derivative steps at exactly integer coordinates (dense
    # convention), so the projection is spelled out as separately
    # rounded products and sums in a fixed order, which the CUDA kernel
    # repeats: both forms then agree bit for bit on which points sit on
    # an integer (a matmul may round, and so land, differently).
    px, py, pw = ph[:, 0], ph[:, 1], ph[:, 2]               # (B, N)

    def row(r):
        return (M0[:, r, 0:1] * px + M0[:, r, 1:2] * py) + M0[:, r, 2:3] * pw

    winv = torch.reciprocal(row(2))
    xr, yr = row(0) * winv, row(1) * winv                   # (B, N)
    Qs = (M0[:, None] @ gens[None]) @ ph[:, None]           # (B, S, 3, N)
    # quotient rule: d(u/w)/dp = (du - (u/w) dw) / w
    jx = (Qs[:, :, 0] - xr[:, None] * Qs[:, :, 2]) * winv[:, None]
    jy = (Qs[:, :, 1] - yr[:, None] * Qs[:, :, 2]) * winv[:, None]
    x = torch.clamp(xr, 0.001, wc - 1.001)
    y = torch.clamp(yr, 0.001, hc - 1.001)
    kx = torch.arange(wc, dtype=x.dtype, device=x.device)
    ky = torch.arange(hc, dtype=y.dtype, device=y.device)
    wx, dwx = _weights_dense(kx - x[..., None])             # (B, N, Wc)
    wy, dwy = _weights_dense(ky - y[..., None])             # (B, N, Hc)
    win_t = window.to(wx.dtype).transpose(1, 2)             # (B, Wc, Hc)
    tmp = wx @ win_t                                        # (B, N, Hc)
    tmp_dx = dwx @ win_t
    val = (wy * tmp).sum(-1)
    dx = -(wy * tmp_dx).sum(-1)
    dy = -(dwy * tmp).sum(-1)
    r = templ - val
    Jm = jx * dx[:, None] + jy * dy[:, None]                # (B, S, N)
    g = (Jm * r[:, None]).sum(-1)
    return val, g, Jm @ Jm.transpose(1, 2)


def _check(window, M0, gens, ph, templ):
    dev = window.device
    for name, t in (("window", window), ("M0", M0), ("gens", gens),
                    ("ph", ph), ("templ", templ)):
        if t.device != dev:
            raise ValueError(f"lk_fused_chain: {name} on {t.device}, "
                             f"window on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"lk_fused_chain: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lk_fused_chain: {name} must be contiguous")
    if window.dim() != 3 or window.shape[1] < 2 or window.shape[2] < 2:
        raise ValueError(f"lk_fused_chain: window must be (B, Hc, Wc) with "
                         f"Hc, Wc >= 2, got {tuple(window.shape)}")
    b = window.shape[0]
    n = ph.shape[-1]
    want = {"M0": (M0, (b, 3, 3)), "gens": (gens, (N_STATE, 3, 3)),
            "ph": (ph, (b, 3, n)), "templ": (templ, (b, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"lk_fused_chain: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
    if b < 1 or n < 1:
        raise ValueError("lk_fused_chain: empty batch or point set")


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    fn = _build.load("lk_fused_chain").lib.lk_fused_chain_ssd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lk_fused_chain(window: torch.Tensor, M0: torch.Tensor,
                   gens: torch.Tensor, ph: torch.Tensor,
                   templ: torch.Tensor):
    """One chain-fused SSD iteration for B trackers (contract of
    `lk_fused_chain_ref`). CPU tensors run the plain form; CUDA tensors
    launch the CUDA kernel on the current stream."""
    if window.device.type == "cpu":
        return lk_fused_chain_ref(window, M0, gens, ph, templ)
    if window.device.type != "cuda":
        raise ValueError(f"lk_fused_chain: unsupported device {window.device}")
    _check(window, M0, gens, ph, templ)
    b, hc, wc = window.shape
    n = ph.shape[-1]
    val = torch.empty((b, n), dtype=torch.float32, device=window.device)
    g = torch.empty((b, N_STATE), dtype=torch.float32, device=window.device)
    jtj = torch.empty((b, N_STATE, N_STATE), dtype=torch.float32,
                      device=window.device)
    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(window.data_ptr(), M0.data_ptr(), gens.data_ptr(),
                           ph.data_ptr(), templ.data_ptr(), val.data_ptr(),
                           g.data_ptr(), jtj.data_ptr(), b, hc, wc, n, stream)
    if err != 0:
        raise RuntimeError(f"lk_fused_chain: kernel launch failed with CUDA "
                           f"error {err}")
    lk_fused_chain.launches += 1
    return val, g, jtj


lk_fused_chain.launches = 0
