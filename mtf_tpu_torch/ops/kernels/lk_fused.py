"""Fused LK iterations (port of `mtf_tpu/ops/pallas/lk_fused.py`): the
chain-fused iteration `lk_fused_chain` in its SSD, NCC-moment, ESM and
multi-channel SSD modes, each with linear, Catmull-Rom (`cubic`) or cubic
B-spline (`cubic_bspl`) taps, plain or binomially blurred (K4b), at every
state size S of the matrix SSMs; and `lk_fused_gn_t` (K6), the same
gradient and normal matrix from a precomputed warp Jacobian.

One chain call is one Gauss-Newton iteration for B trackers: project the
homogeneous base points through the window warp M0, form the
quotient-rule warp Jacobian over the S generators, sample the window
with the dense conventions of `kind`, form the pixel Jacobian Jm (with
`j0`, the ESM mean ½(Jm + J0)) and reduce it per tracker. What is
reduced depends on `am`:

  * "ssd": g = Jm (templ - val) and Jm Jmᵀ (the K1 mode); with a
    channel-stacked window (B, C, Hc, Wc) and templ (B, C, N) each
    channel c samples its own window at the shared taps, forms its own
    Jm_c, and g and Jm Jmᵀ sum over the channels (the K4 mode, C 1-4);
  * "ncc": `templ` is the centred unit template n0, and the kernel emits
    the raw moments a = Σ Jm n0, R = Σ Jm Jmᵀ, [Σ Jm v; Σ Jm] and the
    scalars (Σv, Σv², Σ n0 v, live count, Σ n0) (the K2 mode);
    `ncc_combine` turns them into the NCC gradient and selft Hessian.

The cubic kinds (K1c) clamp coordinates to [1.001, size - 2.001] and read
4x4 taps; linear clamps to [0.001, size - 1.001] and reads 2x2. With
`blur` > 1 (K4b) the taps are the binomial-convolved ones of
`dense_sample._weights_dense`, which reach r = blur - 1 further on each
side, and both clamp margins grow by r (`lk_fused.py:258-262` in the JAX
package): sampling the raw window so equals sampling the blurred window.

Three levels of the chain kernel, each with one contract:

  * `lk_fused_chain_ref`: plain PyTorch, the dense tap-weight math of the
    TPU kernel (`_weights_dense`) with full-float32 contractions; returns
    the raw per-tracker sums. A window shared by every tracker (the frame
    at a batch stride of 0) is read by one product over all trackers'
    points, never copied per tracker, and trackers are taken in chunks
    whose tap-weight matrices hold at most `REF_CHUNK_ELEMS` elements
    (the sub-tracker grid without a crop: 38,400 sub-trackers on a
    480x640 frame);
  * `lk_fused_chain_raw`: the same outputs; CPU tensors take the plain
    form, CUDA tensors launch the CUDA kernel `csrc/lk_fused_chain.cu`
    (see the source for its design), built once per state size S; there
    is no fallback between them. Only the instantiations the trackers
    reach exist (`INSTANTIATIONS`: multi-channel with SSD and without ESM
    only), each at every S of `STATE_DIMS` (the DOFs of the matrix SSMs)
    and with plain or blurred taps; any other combination raises
    `ValueError` on every device. `lk_fused_chain_raw.launches` counts
    kernel launches per instantiation (`mode_name`: "ssd", "ncc_esm",
    "ssd_mc", "ssd@cubic", "ssd:s6@cubic", "ncc:s2+blur", ...; a launch
    with the bfloat16-operand flag counts under "+bf16": "ssd+bf16").
    With `bf16` (plain taps only) the kernel rounds its tap and derivative
    weights to bfloat16, as `interp_bf16` asks (a library of its own per
    S, `-DLK_BF16=1`, whose cubic weights are the plain form's bit for
    bit before the rounding); the window's values are rounded where the
    caller makes it;
  * `lk_fused_chain`: the JAX contract, (val, g, h); for NCC the raw
    moments go through `ncc_combine` (h is the NEGATED selft Hessian, as
    in JAX: the caller uses H = -h).

K6 has two levels, `lk_fused_gn_t_ref` (plain) and `lk_fused_gn_t`
(dispatch, CUDA kernel `csrc/lk_fused_gn.cu`, launches counted per
`gn_mode_name` in `lk_fused_gn_t.launches`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.kernels import _build
from mtf_tpu_torch.ops.kernels.dense_sample import (KINDS, _weights_dense,
                                                    blur_radius)

# state sizes of the matrix SSMs, each its own build of the chain kernel
STATE_DIMS = (2, 3, 4, 5, 6, 8)
MAX_BLUR = 8        # widest binomial blur the kernels take (15 taps)
N_SCALARS = 5       # NCC: s1 = Σv, s2 = Σv², s3 = Σ n0 v, live count, Σ n0
REF_CHUNK_ELEMS = 1 << 30   # the plain form's B·N·(Hc + Wc) per chunk
AMS = ("ssd", "ncc")
MAX_CHANNELS = 4
# (am, esm, multi-channel) of every kernel mode, each built for every kind
MODES = (("ssd", False, False), ("ncc", False, False), ("ssd", True, False),
         ("ncc", True, False), ("ssd", False, True))
INSTANTIATIONS = tuple(m + (k,) for k in KINDS for m in MODES)


def mode_name(am: str, esm: bool, mc: bool = False, kind: str = "linear",
              s: int = 8, blurred: bool = False, bf16: bool = False) -> str:
    """Key of a kernel instantiation in `lk_fused_chain_raw.launches`:
    the mode, then ":s<S>" where S != 8, "+blur" for the blurred taps,
    "+bf16" for the bfloat16-operand flag and "@<kind>" for the cubic
    kinds."""
    name = am + ("_esm" if esm else "") + ("_mc" if mc else "")
    name += (f":s{s}" if s != 8 else "") + ("+blur" if blurred else "")
    name += "+bf16" if bf16 else ""
    return name if kind == "linear" else f"{name}@{kind}"


def _check_s(s: int, who: str) -> None:
    if s not in STATE_DIMS:
        raise ValueError(f"{who}: no kernel for state size S = {s}; the "
                         f"kernels take S in {STATE_DIMS}")


def _check_blur(blur: int, kind: str, hc: int, wc: int, who: str) -> None:
    """A blur outside [0, MAX_BLUR], or whose taps cannot fit the window
    (the widened clip bounds would cross), raises."""
    if not 0 <= blur <= MAX_BLUR:
        raise ValueError(f"{who}: blur must be in 0-{MAX_BLUR}, got {blur}")
    taps = (2 if kind == "linear" else 4) + 2 * blur_radius(blur)
    if hc < taps or wc < taps:
        raise ValueError(f"{who}: a {hc}x{wc} window cannot hold the {taps} "
                         f"taps per axis of {kind} taps at blur {blur}")


def _instantiation(window: torch.Tensor, am: str, j0, kind: str, s: int,
                   blur: int, bf16: bool = False):
    """(am, esm, mc, kind, S, blurred) of a call, or ValueError where the
    kernel has no such instantiation (the bf16 flag takes plain taps
    only)."""
    if bf16 and blur > 1:
        raise ValueError("lk_fused_chain: the bf16 flag takes plain taps "
                         "only (blur 0 or 1)")
    if am not in AMS:
        raise ValueError(f"lk_fused_chain: am must be one of {AMS}, "
                         f"got {am!r}")
    if kind not in KINDS:
        raise ValueError(f"lk_fused_chain: kind must be one of {KINDS}, "
                         f"got {kind!r}")
    _check_s(s, "lk_fused_chain")
    _check_blur(blur, kind, window.shape[-2], window.shape[-1],
                "lk_fused_chain")
    inst = (am, j0 is not None, window.dim() == 4, kind)
    if inst not in INSTANTIATIONS:
        raise ValueError(f"lk_fused_chain: no kernel for {mode_name(*inst)}"
                         ": multi-channel windows take SSD without ESM only")
    return inst + (s, blur > 1)


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


def _sample_dense(win: torch.Tensor, xr: torch.Tensor, yr: torch.Tensor,
                  kind: str, blur: int = 0, bf16: bool = False):
    """Dense-convention samples of windows (B, C, Hc, Wc) at window
    coordinates (B, N), clamped to the margins of `kind` widened by the
    blur radius -> val, dx, dy, each (B, C, N). `bf16`: the tap and
    derivative weights rounded to bfloat16 (the window's values are the
    caller's), every product and sum float32."""
    hc, wc = win.shape[-2:]
    lo, hi = interp._clamp_margins(kind)
    r = blur_radius(blur)
    x = torch.clamp(xr, lo + r, (wc - hi) - r)
    y = torch.clamp(yr, lo + r, (hc - hi) - r)
    kx = torch.arange(wc, dtype=x.dtype, device=x.device)
    ky = torch.arange(hc, dtype=y.dtype, device=y.device)
    wx, dwx = _weights_dense(kx - x[..., None], kind, blur)  # (B, N, Wc)
    wy, dwy = _weights_dense(ky - y[..., None], kind, blur)  # (B, N, Hc)
    if bf16:
        wx, dwx, wy, dwy = map(interp.round_bf16, (wx, dwx, wy, dwy))
    if shared_window(win):
        # one frame read by every tracker: one product over all B·N
        # points, never a copy of the frame per tracker
        b, n = wx.shape[:2]
        c = win.shape[1]
        rhs = win[0].to(wx.dtype).permute(2, 0, 1).reshape(wc, c * hc)
        tmp, tmp_dx = ((w.reshape(b * n, wc) @ rhs).view(b, n, c, hc)
                       .transpose(1, 2) for w in (wx, dwx))
    else:
        win_t = win.to(wx.dtype).transpose(-1, -2)          # (B, C, Wc, Hc)
        tmp = wx[:, None] @ win_t                           # (B, C, N, Hc)
        tmp_dx = dwx[:, None] @ win_t
    val = (wy[:, None] * tmp).sum(-1)                       # (B, C, N)
    dx = -(wy[:, None] * tmp_dx).sum(-1)
    dy = -(dwy[:, None] * tmp).sum(-1)
    return val, dx, dy


def project_points(M0: torch.Tensor, gens: torch.Tensor, ph: torch.Tensor):
    """The chain kernel's geometry: base points ph (B, 3, N) through the
    warps M0 (B, 3, 3) -> window coordinates xr, yr (B, N) and the
    quotient-rule warp Jacobian jx, jy (B, S, N) over the generators gens
    (S, 3, 3). The linear derivative steps at exactly integer coordinates
    (dense convention), so the projection is spelled out as separately
    rounded products and sums in a fixed order, which the CUDA kernel
    repeats: both forms then agree bit for bit on which points sit on an
    integer (a matmul may round, and so land, differently)."""
    px, py, pw = ph[:, 0], ph[:, 1], ph[:, 2]               # (B, N)

    def row(r):
        return (M0[:, r, 0:1] * px + M0[:, r, 1:2] * py) + M0[:, r, 2:3] * pw

    winv = torch.reciprocal(row(2))
    xr, yr = row(0) * winv, row(1) * winv
    Qs = (M0[:, None] @ gens[None]) @ ph[:, None]           # (B, S, 3, N)
    # quotient rule: d(u/w)/dp = (du - (u/w) dw) / w
    jx = (Qs[:, :, 0] - xr[:, None] * Qs[:, :, 2]) * winv[:, None]
    jy = (Qs[:, :, 1] - yr[:, None] * Qs[:, :, 2]) * winv[:, None]
    return xr, yr, jx, jy


def lk_fused_chain_ref(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor, am: str = "ssd",
                       j0: torch.Tensor | None = None, kind: str = "linear",
                       blur: int = 0, bf16: bool = False):
    """Plain form. window (B, Hc, Wc), or (B, C, Hc, Wc) for the
    multi-channel SSD mode; M0 (B, 3, 3), gens (S, 3, 3), ph (B, 3, N),
    templ (B, N) (NCC: n0) or (B, C, N), j0 (B, S, N) or None; `blur` > 1
    samples with the binomial-blurred taps; `bf16` rounds the tap and
    derivative weights to bfloat16 (plain taps; the window's values are
    the caller's to round) ->
    SSD: val (B, N) or (B, C, N), g (B, S), JtJ (B, S, S);
    NCC: val (B, N), a (B, S), R (B, S, S), mom (B, 2, S), scal (B, 5)."""
    _, _, mc, _, _, _ = _instantiation(window, am, j0, kind, gens.shape[0],
                                       blur, bf16)
    chunks = ref_chunks(ph.shape[0], ph.shape[-1], *window.shape[-2:])
    if len(chunks) > 1:
        parts = [lk_fused_chain_ref(
            window[c], M0[c], gens, ph[c], templ[c], am,
            None if j0 is None else j0[c], kind, blur, bf16) for c in chunks]
        return tuple(torch.cat(x) for x in zip(*parts))
    win = window if mc else window[:, None]                 # (B, C, Hc, Wc)
    xr, yr, jx, jy = project_points(M0, gens, ph)
    val, dx, dy = _sample_dense(win, xr, yr, kind, blur, bf16)
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


def ref_chunks(b: int, n: int, hc: int, wc: int) -> list:
    """The slices of B trackers the plain forms take at a time: each
    chunk's tap-weight matrices (its trackers' N points times Hc + Wc)
    hold at most REF_CHUNK_ELEMS elements."""
    step = max(1, REF_CHUNK_ELEMS // max(1, n * (hc + wc)))
    return [slice(i, min(i + step, b)) for i in range(0, b, step)]


def shared_window(window: torch.Tensor) -> bool:
    """True for one window read by every tracker: a batch stride of 0
    (`expand` of the shared frame) over a contiguous window."""
    return (window.dim() >= 3 and window.shape[0] > 1
            and window.stride(0) == 0 and window[0].is_contiguous())


def _check_tensors(who: str, named) -> None:
    """Every tensor on the first one's device, float32 and contiguous (the
    first, the window, may be a shared one, `shared_window`)."""
    dev = named[0][1].device
    for i, (name, t) in enumerate(named):
        if t.device != dev:
            raise ValueError(f"{who}: {name} on {t.device}, "
                             f"{named[0][0]} on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if not (t.is_contiguous() or (i == 0 and shared_window(t))):
            raise ValueError(f"{who}: {name} must be contiguous")


def _check_shapes(who: str, want: dict) -> None:
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _check(window, M0, gens, ph, templ, j0):
    _check_tensors("lk_fused_chain", [
        ("window", window), ("M0", M0), ("gens", gens), ("ph", ph),
        ("templ", templ)] + ([("j0", j0)] if j0 is not None else []))
    mc = window.dim() == 4
    if (window.dim() not in (3, 4)
            or (mc and not 1 <= window.shape[1] <= MAX_CHANNELS)):
        raise ValueError(f"lk_fused_chain: window must be (B, Hc, Wc) or "
                         f"(B, C, Hc, Wc) with C in 1-{MAX_CHANNELS}, got "
                         f"{tuple(window.shape)}")
    b = window.shape[0]
    n = ph.shape[-1]
    s = gens.shape[0]
    want = {"M0": (M0, (b, 3, 3)), "gens": (gens, (s, 3, 3)),
            "ph": (ph, (b, 3, n)),
            "templ": (templ, (b, window.shape[1], n) if mc else (b, n))}
    if j0 is not None:
        want["j0"] = (j0, (b, s, n))
    _check_shapes("lk_fused_chain", want)
    if b < 1 or n < 1:
        raise ValueError("lk_fused_chain: empty batch or point set")


# the warps a tracker's block of the CUDA chain kernel may have, and the
# 32-point chunks each of them takes where N has enough: at small N a
# block of fewer warps leaves room on the SM for more trackers at once (a
# sweep of 1-8 warps on the card, PERF.md §6: 3 warps at N = 169 within
# 3% of the best, 1 at the sub-tracker grid's 16 and 64, 8 at 2500; at
# 625, 7 warps (3 chunks each) ran 14% faster than these 8, but moved the
# LM refiner of one rklt tracker across an accept/reject tie)
MAX_WARPS = 8
CHUNKS_PER_WARP = 2


def block_warps(n: int) -> int:
    """Warps of each tracker's block of the CUDA chain kernel for N = n
    points: one per CHUNKS_PER_WARP chunks of 32 points, 1 to
    MAX_WARPS."""
    chunks = -(-n // 32)
    return max(1, min(MAX_WARPS, -(-chunks // CHUNKS_PER_WARP)))


def build_defines(s: int, bf16: bool = False) -> dict:
    """The defines of the chain kernel's library of state size `s`, with
    the bfloat16-operand flag (`-DLK_BF16=1`, its own library) or not."""
    return {"LK_S": s, "LK_BF16": 1} if bf16 else {"LK_S": s}


@functools.cache
def _kernel_fn(s: int, bf16: bool = False):
    """The chain kernels' C entry point of state size `s` (and flag),
    built (one library per S and flag, `build_defines`) and bound on first
    use."""
    fn = _build.load("lk_fused_chain",
                     build_defines(s, bf16)).lib.lk_fused_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _out(device, *shape):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def lk_fused_chain_raw(window: torch.Tensor, M0: torch.Tensor,
                       gens: torch.Tensor, ph: torch.Tensor,
                       templ: torch.Tensor, am: str = "ssd",
                       j0: torch.Tensor | None = None, kind: str = "linear",
                       blur: int = 0, bf16: bool = False):
    """One chain-fused iteration's raw per-tracker sums for B trackers
    (contract of `lk_fused_chain_ref`). CPU tensors run the plain form;
    CUDA tensors launch the CUDA kernel on the current stream. The window
    may be one shared by every tracker (`shared_window`: the frame
    expanded with batch stride 0), which the kernel reads in place."""
    inst = _instantiation(window, am, j0, kind, gens.shape[0], blur, bf16)
    if window.device.type == "cpu":
        return lk_fused_chain_ref(window, M0, gens, ph, templ, am, j0, kind,
                                  blur, bf16)
    if window.device.type != "cuda":
        raise ValueError(f"lk_fused_chain: unsupported device {window.device}")
    _check(window, M0, gens, ph, templ, j0)
    _, esm, mc, _, s, _ = inst
    b, hc, wc = window.shape[0], window.shape[-2], window.shape[-1]
    c = window.shape[1] if mc else 1
    n = ph.shape[-1]
    ncc = am == "ncc"
    dev = window.device
    val = _out(dev, b, c, n) if mc else _out(dev, b, n)
    g, h = _out(dev, b, s), _out(dev, b, s, s)
    mom = _out(dev, b, 2, s) if ncc else None
    scal = _out(dev, b, N_SCALARS) if ncc else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(s, bf16)(window.data_ptr(), M0.data_ptr(), gens.data_ptr(),
                            ph.data_ptr(), templ.data_ptr(), _ptr(j0),
                            val.data_ptr(), g.data_ptr(), h.data_ptr(),
                            _ptr(mom), _ptr(scal), b, hc, wc, n, c,
                            int(ncc), int(esm), int(mc), KINDS.index(kind),
                            blur, block_warps(n), int(shared_window(window)),
                            int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"lk_fused_chain: kernel launch failed with CUDA "
                           f"error {err}")
    lk_fused_chain_raw.launches[mode_name(*inst, bf16=bf16)] += 1
    return (val, g, h, mom, scal) if ncc else (val, g, h)


lk_fused_chain_raw.launches = {
    mode_name(*i, s=s, blurred=bl, bf16=bf): 0
    for s in STATE_DIMS for bl in (False, True) for i in INSTANTIATIONS
    for bf in ((False, True) if not bl else (False,))}


def lk_fused_chain(window: torch.Tensor, M0: torch.Tensor,
                   gens: torch.Tensor, ph: torch.Tensor,
                   templ: torch.Tensor, am: str = "ssd",
                   j0: torch.Tensor | None = None, kind: str = "linear",
                   blur: int = 0, bf16: bool = False):
    """One chain-fused LK iteration -> (val (B, N) or (B, C, N), g (B, S),
    h (B, S, S)), the JAX wrapper's contract: SSD g = Jmᵀ(templ - val),
    h = JmᵀJm (summed over channels); NCC (templ = n0) g the NCC gradient,
    h the negated selft Hessian."""
    out = lk_fused_chain_raw(window, M0, gens, ph, templ, am, j0, kind, blur,
                             bf16)
    if am == "ssd":
        return out
    val, a, R, mom, scal = out
    return (val,) + ncc_combine(a, R, mom, scal)


# -- K6: lk_fused_gn_t ------------------------------------------------------

GN_INSTANTIATIONS = tuple((s, k) for k in KINDS for s in STATE_DIMS)


def gn_mode_name(s: int, kind: str = "linear") -> str:
    """Key of a K6 instantiation in `lk_fused_gn_t.launches`."""
    name = "gn" + (f":s{s}" if s != 8 else "")
    return name if kind == "linear" else f"{name}@{kind}"


def gn_crop(pts: torch.Tensor, h: int, w: int, crop: int | None):
    """The JAX package's K6 window rule (`lk_fused.py:180-186`): with a
    `crop` under the image size, each tracker's (hc, wc) window starts at
    clip(floor(min(points)) - 2, 0, size - crop) per axis. Returns
    (origin (B, 2) float (x0, y0), hc, wc); origin 0 and the whole image
    without a crop."""
    if crop is None or (crop >= h and crop >= w):
        return torch.zeros_like(pts[:, :, 0]), h, w
    hc, wc = min(crop, h), min(crop, w)
    lo = torch.floor(pts.amin(-1)) - 2.0                     # (B, 2)
    x0 = torch.clamp(lo[:, 0], 0.0, float(w - wc))
    y0 = torch.clamp(lo[:, 1], 0.0, float(h - hc))
    return torch.stack([x0, y0], dim=-1).contiguous(), hc, wc


def lk_fused_gn_t_ref(window: torch.Tensor, pts: torch.Tensor,
                      jac: torch.Tensor, templ: torch.Tensor,
                      kind: str = "linear", crop: int | None = None):
    """Plain form of K6. window (B, H, W), pts (B, 2, N) image px, jac
    (B, 2S, N) the warp Jacobian rows [Jx_0..Jx_{S-1}; Jy_0..Jy_{S-1}],
    templ (B, N) -> val (B, N), g (B, S) = Σ Jm (templ - val),
    JᵀJ (B, S, S) = Σ Jm Jmᵀ with Jm = Jx dx + Jy dy, sampled with the
    dense taps of `kind` in each tracker's `gn_crop` window."""
    _gn_instantiation(window, jac, kind)
    b, h, w = window.shape
    origin, hc, wc = gn_crop(pts, h, w, crop)
    oi = origin.long()
    rows = oi[:, 1, None] + torch.arange(hc, device=window.device)
    cols = oi[:, 0, None] + torch.arange(wc, device=window.device)
    sub = window[torch.arange(b, device=window.device)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]         # (B, hc, wc)
    xy = pts - origin[:, :, None]
    val, dx, dy = _sample_dense(sub[:, None], xy[:, 0], xy[:, 1], kind)
    s = jac.shape[1] // 2
    Jm = jac[:, :s] * dx + jac[:, s:] * dy                   # (B, S, N)
    val = val[:, 0]
    return val, (Jm * (templ - val)[:, None]).sum(-1), \
        Jm @ Jm.transpose(1, 2)


def _gn_instantiation(window, jac, kind):
    if kind not in KINDS:
        raise ValueError(f"lk_fused_gn_t: kind must be one of {KINDS}, got "
                         f"{kind!r}")
    if jac.dim() != 3 or jac.shape[1] % 2:
        raise ValueError(f"lk_fused_gn_t: jac must be (B, 2S, N), got "
                         f"{tuple(jac.shape)}")
    s = jac.shape[1] // 2
    _check_s(s, "lk_fused_gn_t")
    _check_blur(0, kind, window.shape[-2], window.shape[-1], "lk_fused_gn_t")
    return s, kind


@functools.cache
def _gn_kernel_fn():
    fn = _build.load("lk_fused_gn").lib.lk_fused_gn_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lk_fused_gn_t(window: torch.Tensor, pts: torch.Tensor, jac: torch.Tensor,
                  templ: torch.Tensor, kind: str = "linear",
                  crop: int | None = None):
    """K6 for B trackers (contract of `lk_fused_gn_t_ref`). CPU tensors
    run the plain form; CUDA tensors launch the CUDA kernel on the current
    stream, which reads each tracker's crop window in place."""
    inst = _gn_instantiation(window, jac, kind)
    if window.device.type == "cpu":
        return lk_fused_gn_t_ref(window, pts, jac, templ, kind, crop)
    if window.device.type != "cuda":
        raise ValueError(f"lk_fused_gn_t: unsupported device {window.device}")
    _check_tensors("lk_fused_gn_t", [("window", window), ("pts", pts),
                                     ("jac", jac), ("templ", templ)])
    if window.dim() != 3:
        raise ValueError(f"lk_fused_gn_t: window must be (B, H, W), got "
                         f"{tuple(window.shape)}")
    b, h, w = window.shape
    n = pts.shape[-1]
    s = inst[0]
    _check_shapes("lk_fused_gn_t", {"pts": (pts, (b, 2, n)),
                                    "jac": (jac, (b, 2 * s, n)),
                                    "templ": (templ, (b, n))})
    if b < 1 or n < 1:
        raise ValueError("lk_fused_gn_t: empty batch or point set")
    origin, hc, wc = gn_crop(pts, h, w, crop)
    dev = window.device
    val, g, hh = _out(dev, b, n), _out(dev, b, s), _out(dev, b, s, s)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _gn_kernel_fn()(window.data_ptr(), origin.data_ptr(),
                              pts.data_ptr(), jac.data_ptr(),
                              templ.data_ptr(), val.data_ptr(), g.data_ptr(),
                              hh.data_ptr(), b, h, w, hc, wc, n, s,
                              KINDS.index(kind), stream)
    if err != 0:
        raise RuntimeError(f"lk_fused_gn_t: kernel launch failed with CUDA "
                           f"error {err}")
    lk_fused_gn_t.launches[gn_mode_name(*inst)] += 1
    return val, g, hh


lk_fused_gn_t.launches = {gn_mode_name(*i): 0 for i in GN_INSTANTIATIONS}
