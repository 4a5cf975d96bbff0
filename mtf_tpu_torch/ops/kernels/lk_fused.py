"""Chain-fused LK iteration (port of
`mtf_tpu/ops/pallas/lk_fused.py:lk_fused_chain`): the SSD, NCC-moment,
ESM and multi-channel SSD modes, each with linear, Catmull-Rom (`cubic`)
or cubic B-spline (`cubic_bspl`) taps.

One call is one Gauss-Newton iteration for B trackers: project the
homogeneous base points through the window warp M0, form the
quotient-rule warp Jacobian, sample the window with the dense conventions
of `kind`, form the pixel Jacobian Jm (with `j0`, the ESM mean
½(Jm + J0)) and reduce it per tracker. What is reduced depends on `am`:

  * "ssd": g = Jm (templ - val) and Jm Jmᵀ (the K1 mode); with a
    channel-stacked window (B, C, Hc, Wc) and templ (B, C, N) each
    channel c samples its own window at the shared taps, forms its own
    Jm_c, and g and Jm Jmᵀ sum over the channels (the K4 mode, C 1-4);
  * "ncc": `templ` is the centred unit template n0, and the kernel emits
    the raw moments a = Σ Jm n0, R = Σ Jm Jmᵀ, [Σ Jm v; Σ Jm] and the
    scalars (Σv, Σv², Σ n0 v, live count, Σ n0) (the K2 mode);
    `ncc_combine` turns them into the NCC gradient and selft Hessian.

The cubic kinds (K1c) clamp coordinates to [1.001, size - 2.001] and read
4x4 taps; linear clamps to [0.001, size - 1.001] and reads 2x2.

Three levels, each with one contract:

  * `lk_fused_chain_ref`: plain PyTorch, the dense tap-weight math of the
    TPU kernel (`_weights_dense`) with full-float32 contractions; returns
    the raw per-tracker sums;
  * `lk_fused_chain_raw`: the same outputs; CPU tensors take the plain
    form, CUDA tensors launch the CUDA kernel `csrc/lk_fused_chain.cu`
    (see the source for its design); there is no fallback between them.
    Only the instantiations the trackers reach exist (`INSTANTIATIONS`:
    multi-channel with SSD and without ESM only); any other combination
    raises `ValueError` on every device. `lk_fused_chain_raw.launches`
    counts kernel launches per instantiation (`mode_name`: "ssd",
    "ncc_esm", "ssd_mc", "ssd@cubic", "ncc_esm@cubic_bspl", ...);
  * `lk_fused_chain`: the JAX contract, (val, g, h); for NCC the raw
    moments go through `ncc_combine` (h is the NEGATED selft Hessian, as
    in JAX: the caller uses H = -h).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels.dense_sample import KINDS, _weights_dense

N_STATE = 8
N_SCALARS = 5       # NCC: s1 = Σv, s2 = Σv², s3 = Σ n0 v, live count, Σ n0
AMS = ("ssd", "ncc")
MAX_CHANNELS = 4
# (am, esm, multi-channel) of every kernel mode, each built for every kind
MODES = (("ssd", False, False), ("ncc", False, False), ("ssd", True, False),
         ("ncc", True, False), ("ssd", False, True))
INSTANTIATIONS = tuple(m + (k,) for k in KINDS for m in MODES)


def mode_name(am: str, esm: bool, mc: bool = False,
              kind: str = "linear") -> str:
    """Key of a kernel instantiation in `lk_fused_chain_raw.launches`."""
    name = am + ("_esm" if esm else "") + ("_mc" if mc else "")
    return name if kind == "linear" else f"{name}@{kind}"


def _instantiation(window: torch.Tensor, am: str, j0, kind: str):
    """(am, esm, mc, kind) of a call, or ValueError where the kernel has no
    such instantiation."""
    if am not in AMS:
        raise ValueError(f"lk_fused_chain: am must be one of {AMS}, "
                         f"got {am!r}")
    if kind not in KINDS:
        raise ValueError(f"lk_fused_chain: kind must be one of {KINDS}, "
                         f"got {kind!r}")
    inst = (am, j0 is not None, window.dim() == 4, kind)
    if inst not in INSTANTIATIONS:
        raise ValueError(f"lk_fused_chain: no kernel for {mode_name(*inst)}"
                         ": multi-channel windows take SSD without ESM only")
    return inst


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
                       j0: torch.Tensor | None = None, kind: str = "linear"):
    """Plain form. window (B, Hc, Wc), or (B, C, Hc, Wc) for the
    multi-channel SSD mode; M0 (B, 3, 3), gens (S, 3, 3), ph (B, 3, N),
    templ (B, N) (NCC: n0) or (B, C, N), j0 (B, S, N) or None ->
    SSD: val (B, N) or (B, C, N), g (B, S), JtJ (B, S, S);
    NCC: val (B, N), a (B, S), R (B, S, S), mom (B, 2, S), scal (B, 5)."""
    _, _, mc, _ = _instantiation(window, am, j0, kind)
    win = window if mc else window[:, None]                 # (B, C, Hc, Wc)
    hc, wc = win.shape[-2:]
    # The linear derivative steps at exactly integer coordinates (dense
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
    lo, hi = interp._clamp_margins(kind)
    x = torch.clamp(xr, lo, wc - hi)
    y = torch.clamp(yr, lo, hc - hi)
    kx = torch.arange(wc, dtype=x.dtype, device=x.device)
    ky = torch.arange(hc, dtype=y.dtype, device=y.device)
    wx, dwx = _weights_dense(kx - x[..., None], kind)       # (B, N, Wc)
    wy, dwy = _weights_dense(ky - y[..., None], kind)       # (B, N, Hc)
    win_t = win.to(wx.dtype).transpose(-1, -2)              # (B, C, Wc, Hc)
    tmp = wx[:, None] @ win_t                               # (B, C, N, Hc)
    tmp_dx = dwx[:, None] @ win_t
    val = (wy[:, None] * tmp).sum(-1)                       # (B, C, N)
    dx = -(wy[:, None] * tmp_dx).sum(-1)
    dy = -(dwy[:, None] * tmp).sum(-1)
    # (B, C, S, N): each channel's own Jm through the shared warp Jacobian
    Jm = jx[:, None] * dx[:, :, None] + jy[:, None] * dy[:, :, None]
    if mc:
        r = templ - val
        g = (Jm * r[:, :, None]).sum((1, 3))
        return val, g, (Jm @ Jm.transpose(-1, -2)).sum(1)
    val, Jm = val[:, 0], Jm[:, 0]
    if j0 is not None:
        # ESM: mean of the current and the template Jacobians
        Jm = 0.5 * (Jm + j0)
    if am == "ncc":
        return (val,) + ncc_moments(val, templ, Jm)
    r = templ - val
    g = (Jm * r[:, None]).sum(-1)
    return val, g, Jm @ Jm.transpose(1, 2)


def _check(window, M0, gens, ph, templ, j0, kind):
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
    least = 2 if kind == "linear" else 4
    mc = window.dim() == 4
    if (window.dim() not in (3, 4) or window.shape[-2] < least
            or window.shape[-1] < least
            or (mc and not 1 <= window.shape[1] <= MAX_CHANNELS)):
        raise ValueError(f"lk_fused_chain: window must be (B, Hc, Wc) or "
                         f"(B, C, Hc, Wc) with C in 1-{MAX_CHANNELS} and "
                         f"Hc, Wc >= {least} for {kind} taps, got "
                         f"{tuple(window.shape)}")
    b = window.shape[0]
    n = ph.shape[-1]
    want = {"M0": (M0, (b, 3, 3)), "gens": (gens, (N_STATE, 3, 3)),
            "ph": (ph, (b, 3, n)),
            "templ": (templ, (b, window.shape[1], n) if mc else (b, n))}
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
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lk_fused_chain_raw(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor, am: str = "ssd",
                       j0: torch.Tensor | None = None, kind: str = "linear"):
    """One chain-fused iteration's raw per-tracker sums for B trackers
    (contract of `lk_fused_chain_ref`). CPU tensors run the plain form;
    CUDA tensors launch the CUDA kernel on the current stream."""
    inst = _instantiation(window, am, j0, kind)
    if window.device.type == "cpu":
        return lk_fused_chain_ref(window, M0, gens, ph, templ, am, j0, kind)
    if window.device.type != "cuda":
        raise ValueError(f"lk_fused_chain: unsupported device {window.device}")
    _check(window, M0, gens, ph, templ, j0, kind)
    _, esm, mc, _ = inst
    b, hc, wc = window.shape[0], window.shape[-2], window.shape[-1]
    c = window.shape[1] if mc else 1
    n = ph.shape[-1]
    ncc = am == "ncc"

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=window.device)

    val = out(b, c, n) if mc else out(b, n)
    g, h = out(b, N_STATE), out(b, N_STATE, N_STATE)
    mom = out(b, 2, N_STATE) if ncc else None
    scal = out(b, N_SCALARS) if ncc else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(window.data_ptr(), M0.data_ptr(), gens.data_ptr(),
                           ph.data_ptr(), templ.data_ptr(), ptr(j0),
                           val.data_ptr(), g.data_ptr(), h.data_ptr(),
                           ptr(mom), ptr(scal), b, hc, wc, n, c, int(ncc),
                           int(esm), int(mc), KINDS.index(kind), stream)
    if err != 0:
        raise RuntimeError(f"lk_fused_chain: kernel launch failed with CUDA "
                           f"error {err}")
    lk_fused_chain_raw.launches[mode_name(*inst)] += 1
    return (val, g, h, mom, scal) if ncc else (val, g, h)


lk_fused_chain_raw.launches = {mode_name(*i): 0 for i in INSTANTIATIONS}


def lk_fused_chain(window: torch.Tensor, M0: torch.Tensor,
                   gens: torch.Tensor, ph: torch.Tensor,
                   templ: torch.Tensor, am: str = "ssd",
                   j0: torch.Tensor | None = None, kind: str = "linear"):
    """One chain-fused LK iteration -> (val (B, N) or (B, C, N), g (B, S),
    h (B, S, S)), the JAX wrapper's contract: SSD g = Jmᵀ(templ - val),
    h = JmᵀJm (summed over channels); NCC (templ = n0) g the NCC gradient,
    h the negated selft Hessian."""
    out = lk_fused_chain_raw(window, M0, gens, ph, templ, am, j0, kind)
    if am == "ssd":
        return out
    val, a, R, mom, scal = out
    return (val,) + ncc_combine(a, R, mom, scal)
