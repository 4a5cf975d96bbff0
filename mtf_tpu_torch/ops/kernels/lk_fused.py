"""Chain-fused LK iteration (port of
`mtf_tpu/ops/pallas/lk_fused.py:lk_fused_chain`), SSD and NCC moment
modes, with the optional ESM mean Jacobian.

One call is one Gauss-Newton iteration for B trackers: project the
homogeneous base points through the window warp M0, form the
quotient-rule warp Jacobian, sample the window with the dense linear
conventions, form the pixel Jacobian Jm (with `j0`, the ESM mean
½(Jm + J0)) and reduce it per tracker. What is reduced depends on `am`:

  * "ssd": g = Jm (templ - val) and Jm Jmᵀ (the K1 mode);
  * "ncc": `templ` is the centred unit template n0, and the kernel emits
    the raw moments a = Σ Jm n0, R = Σ Jm Jmᵀ, [Σ Jm v; Σ Jm] and the
    scalars (Σv, Σv², Σ n0 v, live count, Σ n0) (the K2 mode);
    `ncc_combine` turns them into the NCC gradient and selft Hessian.

Three levels, each with one contract:

  * `lk_fused_chain_ref`: plain PyTorch, the dense tap-weight math of the
    TPU kernel (`_weights_dense`) with full-float32 contractions; returns
    the raw per-tracker sums;
  * `lk_fused_chain_raw`: the same outputs; CPU tensors take the plain
    form, CUDA tensors launch the CUDA kernel `csrc/lk_fused_chain.cu`
    (see the source for its design); there is no fallback between them.
    `lk_fused_chain_raw.launches` counts kernel launches per mode
    ("ssd", "ncc", "ssd_esm", "ncc_esm");
  * `lk_fused_chain`: the JAX contract, (val, g, h); for NCC the raw
    moments go through `ncc_combine` (h is the NEGATED selft Hessian, as
    in JAX: the caller uses H = -h).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels.dense_sample import _weights_dense

N_STATE = 8
N_SCALARS = 5       # NCC: s1 = Σv, s2 = Σv², s3 = Σ n0 v, live count, Σ n0
AMS = ("ssd", "ncc")


def mode_name(am: str, esm: bool) -> str:
    """Key of a kernel instantiation in `lk_fused_chain_raw.launches`."""
    return f"{am}_esm" if esm else am


def ncc_moments(val: torch.Tensor, n0: torch.Tensor, Jm: torch.Tensor):
    """NCC raw moments of val (B, N), n0 (B, N), Jm (B, S, N) ->
    (a (B, S), R (B, S, S), mom (B, 2, S), scal (B, 5))."""
    scal = torch.stack([val.sum(-1), (val * val).sum(-1),
                        (n0 * val).sum(-1),
                        torch.full_like(val[:, 0], float(val.shape[-1])),
                        n0.sum(-1)], dim=-1)
    mom = torch.stack([(Jm * val[:, None]).sum(-1), Jm.sum(-1)], dim=1)
    return ((Jm * n0[:, None]).sum(-1), Jm @ Jm.transpose(1, 2), mom, scal)


def ncc_combine(a: torch.Tensor, R: torch.Tensor, mom: torch.Tensor,
                scal: torch.Tensor):
    """The nonlinear NCC combine of the JAX wrapper (`lk_fused.py:562-586`)
    -> (g (B, S), h (B, S, S)): g the exact centred-norm NCC gradient, h
    the NEGATED selft Hessian (ΣJcJcᵀ - uuᵀ) / var with
    ΣJcJcᵀ = R - nv m mᵀ and u = ΣJm c / (‖c‖ + eps). The eps conventions
    are JAX's: var floored at 1e-12, eps 1e-8, nv at least 1."""
    bv, mrow = mom[:, 0], mom[:, 1]
    s1, s2, s3 = scal[:, 0], scal[:, 1], scal[:, 2]
    nv = torch.clamp(scal[:, 3], min=1.0)
    mu = s1 / nv
    var = torch.clamp(s2 - s1 * s1 / nv, min=1e-12)
    nrm = torch.sqrt(var)
    eps = 1e-8
    dotc = s3 - mu * scal[:, 4]
    jc = bv - mu[:, None] * mrow                           # Σ Jm c
    g = a / (nrm + eps)[:, None] \
        - dotc[:, None] * jc / (nrm * (nrm + eps) ** 2)[:, None]
    m = mrow / nv[:, None]
    u = jc / (nrm + eps)[:, None]
    h = (R - nv[:, None, None] * (m[:, :, None] * m[:, None, :])
         - u[:, :, None] * u[:, None, :]) / var[:, None, None]
    return g, h


def lk_fused_chain_ref(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor, am: str = "ssd",
                       j0: torch.Tensor | None = None):
    """Plain form. window (B, Hc, Wc), M0 (B, 3, 3), gens (S, 3, 3),
    ph (B, 3, N), templ (B, N) (NCC: n0), j0 (B, S, N) or None ->
    SSD: val (B, N), g (B, S), JtJ (B, S, S);
    NCC: val (B, N), a (B, S), R (B, S, S), mom (B, 2, S), scal (B, 5)."""
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
    Jm = jx * dx[:, None] + jy * dy[:, None]                # (B, S, N)
    if j0 is not None:
        # ESM: mean of the current and the template Jacobians
        Jm = 0.5 * (Jm + j0)
    if am == "ncc":
        return (val,) + ncc_moments(val, templ, Jm)
    r = templ - val
    g = (Jm * r[:, None]).sum(-1)
    return val, g, Jm @ Jm.transpose(1, 2)


def _check(window, M0, gens, ph, templ, j0):
    dev = window.device
    named = [("window", window), ("M0", M0), ("gens", gens), ("ph", ph),
             ("templ", templ)] + ([("j0", j0)] if j0 is not None else [])
    for name, t in named:
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
    if j0 is not None:
        want["j0"] = (j0, (b, N_STATE, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"lk_fused_chain: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
    if b < 1 or n < 1:
        raise ValueError("lk_fused_chain: empty batch or point set")


@functools.cache
def _kernel_fn():
    """The kernels' C entry point, built and bound on first use."""
    fn = _build.load("lk_fused_chain").lib.lk_fused_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lk_fused_chain_raw(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor, am: str = "ssd",
                       j0: torch.Tensor | None = None):
    """One chain-fused iteration's raw per-tracker sums for B trackers
    (contract of `lk_fused_chain_ref`). CPU tensors run the plain form;
    CUDA tensors launch the CUDA kernel on the current stream."""
    if am not in AMS:
        raise ValueError(f"lk_fused_chain: am must be one of {AMS}, "
                         f"got {am!r}")
    if window.device.type == "cpu":
        return lk_fused_chain_ref(window, M0, gens, ph, templ, am, j0)
    if window.device.type != "cuda":
        raise ValueError(f"lk_fused_chain: unsupported device {window.device}")
    _check(window, M0, gens, ph, templ, j0)
    b, hc, wc = window.shape
    n = ph.shape[-1]
    ncc = am == "ncc"

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=window.device)

    val, g, h = out(b, n), out(b, N_STATE), out(b, N_STATE, N_STATE)
    mom = out(b, 2, N_STATE) if ncc else None
    scal = out(b, N_SCALARS) if ncc else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(window.data_ptr(), M0.data_ptr(), gens.data_ptr(),
                           ph.data_ptr(), templ.data_ptr(), ptr(j0),
                           val.data_ptr(), g.data_ptr(), h.data_ptr(),
                           ptr(mom), ptr(scal), b, hc, wc, n, int(ncc),
                           int(j0 is not None), stream)
    if err != 0:
        raise RuntimeError(f"lk_fused_chain: kernel launch failed with CUDA "
                           f"error {err}")
    lk_fused_chain_raw.launches[mode_name(am, j0 is not None)] += 1
    return (val, g, h, mom, scal) if ncc else (val, g, h)


lk_fused_chain_raw.launches = {mode_name(am, esm): 0 for esm in (False, True)
                               for am in AMS}


def lk_fused_chain(window: torch.Tensor, M0: torch.Tensor,
                   gens: torch.Tensor, ph: torch.Tensor,
                   templ: torch.Tensor, am: str = "ssd",
                   j0: torch.Tensor | None = None):
    """One chain-fused LK iteration -> (val (B, N), g (B, S), h (B, S, S)),
    the JAX wrapper's contract: SSD g = Jmᵀ(templ - val), h = JmᵀJm; NCC
    (templ = n0) g the NCC gradient, h the negated selft Hessian."""
    out = lk_fused_chain_raw(window, M0, gens, ph, templ, am, j0)
    if am == "ssd":
        return out
    val, a, R, mom, scal = out
    return (val,) + ncc_combine(a, R, mom, scal)
