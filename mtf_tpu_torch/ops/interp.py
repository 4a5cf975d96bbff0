"""Image patch sampling (port of `mtf_tpu/ops/interp.py`).

Images are (H, W) or (H, W, C) float tensors; points are (..., N, 2) in
(x, y) order with any leading batch dims; patches are (..., N, C). A
(B, H, W, C) tensor holds one image per tracker: `sample_val_grad`,
`sample` and `sample_dense` then read points (B, ..., N, 2) each from its
own tracker's image.
A `FrameStack` (frames (F, H, W, C) and an index (B,)) holds the same
per-tracker images without copies: tracker t reads frame index[t] (the
sub-tracker grid's B·P sub-trackers read their B parents' frames).
Border handling of the gather kinds is 'replicate' (indices clamped into
the image) or 'constant' (a tap outside the image reads `cval`, 0.0 by
default); the dense kinds clamp coordinates (replicate) and ignore
`border` and `cval`, in both packages.

`sample_val_grad` (and `sample`, `sample_grad`) is the gather form of
the JAX package's `sample`: nearest (the pixel at round(x), derivative
0), linear, Catmull-Rom (`cubic`) and cubic B-spline taps at
floor(x) + {-1..2}, indices clamped into the image, the derivative of the
interpolant itself (linear: one-sided at an integer coordinate); a dense
kind ("*_mm") goes to `sample_dense` on the whole image.
`sample_with_grad` is its JAX name, `sample_dense_parts` gives
`sample_dense`'s derivative unstacked, and `sample_grad_fd` /
`sample_hess_fd` are the central-difference gradient and Hessian of
`sample` at points (the reference's grad_pts and getImgHess).

Every sampler is differentiable in the points by autograd and
`torch.func`, and its first derivative is the one it returns: the JAX
package's custom JVP rule (`mtf_tpu/ops/interp.py:166`). The gather
forms are plain tap arithmetic in the fractional offsets (floor and round
have derivative 0). The dense forms pass the derivative through their
coordinate clamp (`_clamp_st`) and zero it along an axis at an exactly
integer coordinate (the dense linear rule), so their values are
unchanged. Second derivatives are those of the tap arithmetic, as in the
JAX package, except at a clamped coordinate, where the JAX package's is
0 and these are the interpolant's.

`sample_dense` and `sample_windows` keep the JAX dense ("*_mm")
conventions exactly, while reading the taps by gather instead of the
TPU's tap-weight matmuls:
  * coordinates are clamped to [0.001, size - 1.001] of the (cropped)
    window for linear taps and to [1.001, size - 2.001] for the 4x4 cubic
    taps (`cubic`: Catmull-Rom, `cubic_bspl`: cubic B-spline), which
    makes the replicate border and keeps every tap inside;
  * the tap weights and derivatives are the dense kernel's
    (`ops/kernels/dense_sample.py:_weights_dense`): for linear taps
    phi'(t) = -sign(t) for |t| < 1, so at an exactly integer coordinate
    the derivative along that axis is 0, not the one-sided difference a
    gather form would give; the cubic phi' is continuous there.

`interp_bf16` (the `bf16` argument of `sample_dense`, `sample_windows`
and `sample_dense_blocked`) is the JAX package's `compute_dtype=bfloat16`:
the image values and the per-axis tap and derivative weights rounded to
bfloat16 (round to nearest even), every product and sum in float32 (the
first contraction's result is not rounded).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mtf_tpu_torch.ops.kernels.dense_sample import KINDS, _weights_dense

NEAREST = "nearest"
LINEAR = "linear"
CUBIC = "cubic"            # Catmull-Rom
CUBIC_BSPL = "cubic_bspl"  # cubic B-spline
LINEAR_MM = "linear_mm"
CUBIC_MM = "cubic_mm"
CUBIC_BSPL_MM = "cubic_bspl_mm"
MM_SUFFIX = "_mm"          # dense kinds: linear_mm, cubic_mm, cubic_bspl_mm
REPLICATE = "replicate"
CONSTANT = "constant"
BORDERS = (REPLICATE, CONSTANT)


class FrameStack(NamedTuple):
    """Per-tracker frames by index: tracker t reads frame `index[t]` of
    `frames`, so B trackers read F frames without B copies."""
    frames: torch.Tensor    # (F, H, W, C), or (F, C, H, W) for windows
    index: torch.Tensor     # (B,) int64


def _as_hwc(img: torch.Tensor) -> torch.Tensor:
    return img[..., None] if img.dim() == 2 else img


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even), kept in its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _flat(img, x: torch.Tensor):
    """(pixels (·, C), H, W, C, the offset of each point's image in them)
    of an (H, W[, C]) image, of per-tracker images (B, H, W, C) or of a
    `FrameStack`, read at coordinates x (B, ...)."""
    if isinstance(img, FrameStack):
        f, h, w, c = img.frames.shape
        base = (img.index * (h * w)).view((-1,) + (1,) * (x.dim() - 1))
        return img.frames.reshape(f * h * w, c), h, w, c, base
    if img.dim() == 4:
        b, h, w, c = img.shape
        base = (torch.arange(b, device=img.device) * (h * w)).view(
            (b,) + (1,) * (x.dim() - 1))
        return img.reshape(b * h * w, c), h, w, c, base
    img = _as_hwc(img)
    h, w, c = img.shape
    return img.reshape(h * w, c), h, w, c, 0


def _gather(img_flat: torch.Tensor, base, h: int, w: int, xi: torch.Tensor,
            yi: torch.Tensor, border: str = REPLICATE,
            cval: float = 0.0) -> torch.Tensor:
    """Pixel values at integer coords (...,) -> (..., C); `base`, the
    offset of each point's image (`_flat`). The indices are clamped into
    the image; with the constant border a tap outside it reads `cval`
    (`mtf_tpu/ops/interp.py:_gather`)."""
    xc = xi.clamp(0, w - 1)
    yc = yi.clamp(0, h - 1)
    v = img_flat[base + yc * w + xc]
    if border == CONSTANT:
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = torch.where(valid[..., None], v, torch.full_like(v, cval))
    return v


def _cubic_weights(f: torch.Tensor, kind: str):
    """4-tap weights and their derivatives for offsets f in [0, 1)
    (`mtf_tpu/ops/interp.py:_cubic_weights`): Catmull-Rom (`cubic`) or
    cubic B-spline (`cubic_bspl`). Returns (w, dw), 4 tensors each."""
    f2 = f * f
    f3 = f2 * f
    if kind == CUBIC:
        return ((0.5 * (-f + 2.0 * f2 - f3),
                 0.5 * (2.0 - 5.0 * f2 + 3.0 * f3),
                 0.5 * (f + 4.0 * f2 - 3.0 * f3), 0.5 * (-f2 + f3)),
                (0.5 * (-1.0 + 4.0 * f - 3.0 * f2),
                 0.5 * (-10.0 * f + 9.0 * f2),
                 0.5 * (1.0 + 8.0 * f - 9.0 * f2),
                 0.5 * (-2.0 * f + 3.0 * f2)))
    onemf = 1.0 - f
    return ((onemf * onemf * onemf / 6.0, (4.0 - 6.0 * f2 + 3.0 * f3) / 6.0,
             (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) / 6.0, f3 / 6.0),
            (-0.5 * onemf * onemf, (-12.0 * f + 9.0 * f2) / 6.0,
             (3.0 + 6.0 * f - 9.0 * f2) / 6.0, 0.5 * f2))


def sample_val_grad(img: torch.Tensor, pts: torch.Tensor, kind: str = LINEAR,
                    border: str = REPLICATE, need_grad: bool = True,
                    cval: float = 0.0):
    """Values (..., N, C) and, with `need_grad`, the interpolant's
    derivative d/d(x, y) (..., N, C, 2) at subpixel points, by gather
    (`mtf_tpu/ops/interp.py:_sample_val_grad`): `linear` (the one-sided
    difference v01 - v00, also at an exactly integer coordinate, unlike
    the dense convention), `cubic` and `cubic_bspl` 4x4 taps, and the
    dense kinds ("*_mm") through `sample_dense` on the whole image (which
    ignores `border` and `cval`). With the constant border every tap
    outside the image reads `cval`, and the derivative is the
    interpolant's over those values."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}; known: {BORDERS}")
    if kind.endswith(MM_SUFFIX):
        return sample_dense(img, pts, kind[:-len(MM_SUFFIX)],
                            need_grad=need_grad)
    if kind not in KINDS + (NEAREST,):
        raise ValueError(f"unknown interp {kind!r}")
    x, y = pts[..., 0], pts[..., 1]
    img_flat, h, w, c, base = _flat(img, x)

    def tap(xi, yi):
        return _gather(img_flat, base, h, w, xi, yi, border, cval)

    if kind == NEAREST:
        val = tap(torch.round(x).long(), torch.round(y).long())
        return val, (val.new_zeros(val.shape + (2,)) if need_grad else None)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    if kind == LINEAR:
        v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
        v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
        top = v00 * (1.0 - fx) + v01 * fx
        bot = v10 * (1.0 - fx) + v11 * fx
        val = top * (1.0 - fy) + bot * fy
        if not need_grad:
            return val, None
        dx = (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy
        return val, torch.stack([dx, bot - top], dim=-1)
    wx, dwx = _cubic_weights(fx, kind)
    wy, dwy = _cubic_weights(fy, kind)
    rows = [[tap(x0 + i - 1, y0 + j - 1) for i in range(4)]
            for j in range(4)]
    row_v = [sum(rows[j][i] * wx[i] for i in range(4)) for j in range(4)]
    val = sum(row_v[j] * wy[j] for j in range(4))
    if not need_grad:
        return val, None
    row_dx = [sum(rows[j][i] * dwx[i] for i in range(4)) for j in range(4)]
    dx = sum(row_dx[j] * wy[j] for j in range(4))
    dy = sum(row_v[j] * dwy[j] for j in range(4))
    return val, torch.stack([dx, dy], dim=-1)


def sample(img: torch.Tensor, pts: torch.Tensor, kind: str = LINEAR,
           border: str = REPLICATE, cval: float = 0.0) -> torch.Tensor:
    """Sample img at subpixel points -> patch (..., N, C)."""
    return sample_val_grad(img, pts, kind, border, False, cval)[0]


def sample_with_grad(img: torch.Tensor, pts: torch.Tensor,
                     kind: str = LINEAR, border: str = REPLICATE,
                     cval: float = 0.0):
    """(patch (..., N, C), derivative (..., N, C, 2)) in one pass: the
    JAX package's name for `sample_val_grad` with `need_grad`."""
    return sample_val_grad(img, pts, kind, border, True, cval)


def sample_grad(img: torch.Tensor, pts: torch.Tensor, kind: str = LINEAR,
                border: str = REPLICATE, cval: float = 0.0) -> torch.Tensor:
    """The interpolant's derivative at subpixel points -> (..., N, C, 2)
    (`mtf_tpu/ops/interp.py:sample_grad`)."""
    return sample_val_grad(img, pts, kind, border, True, cval)[1]


def _offsets(pts: torch.Tensor, eps: float):
    """The (eps, 0) and (0, eps) steps in the points' dtype and device."""
    z = torch.zeros((), dtype=pts.dtype, device=pts.device)
    e = torch.full((), eps, dtype=pts.dtype, device=pts.device)
    return torch.stack([e, z]), torch.stack([z, e])


def sample_grad_fd(img: torch.Tensor, pts: torch.Tensor, eps: float = 0.5,
                   kind: str = LINEAR, border: str = REPLICATE,
                   cval: float = 0.0) -> torch.Tensor:
    """Central-difference image gradient at points -> (..., N, C, 2), the
    samples `eps` px either side along each axis (the reference's
    grad_pts path, `mtf_tpu/ops/interp.py:sample_grad_fd`)."""
    ex, ey = _offsets(pts, eps)

    def s(p):
        return sample(img, p, kind, border, cval)

    gx = s(pts + ex) - s(pts - ex)
    gy = s(pts + ey) - s(pts - ey)
    return torch.stack([gx, gy], dim=-1) / (2.0 * eps)


def sample_hess_fd(img: torch.Tensor, pts: torch.Tensor, eps: float = 0.5,
                   kind: str = LINEAR, border: str = REPLICATE,
                   cval: float = 0.0) -> torch.Tensor:
    """Finite-difference image Hessian at points -> (..., N, C, 2, 2)
    (the reference's getImgHess, `mtf_tpu/ops/interp.py:sample_hess_fd`)."""
    ex, ey = _offsets(pts, eps)

    def s(p):
        return sample(img, p, kind, border, cval)

    c = s(pts)
    dxx = (s(pts + ex) + s(pts - ex) - 2.0 * c) / (eps * eps)
    dyy = (s(pts + ey) + s(pts - ey) - 2.0 * c) / (eps * eps)
    dxy = (s(pts + ex + ey) + s(pts - ex - ey)
           - s(pts + ex - ey) - s(pts - ex + ey)) / (4.0 * eps * eps)
    return torch.stack([torch.stack([dxx, dxy], dim=-1),
                        torch.stack([dxy, dyy], dim=-1)], dim=-2)


def crop_origin(pts: torch.Tensor, size: int, full: int,
                margin: float) -> torch.Tensor:
    """Window start per batch element along one axis: floor(min) - margin,
    clipped to [0, full - size] (a NaN start, a diverged tracker's, to 0,
    as `jax.lax.dynamic_slice` clamps it). pts: (..., N) coordinates ->
    (...,)."""
    return torch.clamp(torch.nan_to_num(
        torch.floor(pts.amin(dim=-1)) - margin, nan=0.0), 0.0,
        float(full - size))


def _clamp_st(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clamp(v, lo, hi) in value, with derivative 1 everywhere: the dense
    rule differentiates the interpolant at the clamped coordinate."""
    return torch.clamp(v, lo, hi) + (v - v.detach())


def _frac_dense(f: torch.Tensor) -> torch.Tensor:
    """A linear tap fraction whose derivative is 0 where it is exactly 0
    (the dense linear rule at an integer coordinate); same value."""
    return torch.where(f > 0, f, f.detach())


def _clamp_margins(kind: str):
    """(lo, hi) of the dense clamp [lo, size - hi] of `kind`'s taps."""
    if kind not in KINDS:
        raise ValueError(f"unknown dense kind {kind!r}; known: {KINDS}")
    return (0.001, 1.001) if kind == LINEAR else (1.001, 2.001)


def _cubic_axis(c: torch.Tensor, kind: str, bf16: bool = False):
    """The 4 cubic taps along one axis at clamped coordinates c: the
    first tap's index floor(c) - 1, and per tap j its weight phi(t_j) and
    derivative d/dc phi(t_j) = -phi'(t_j), t_j = floor(c) - 1 + j - c
    (exact in float32, as the dense form's k - c is); with `bf16` each
    rounded to bfloat16."""
    f = torch.floor(c)
    ws, ds = [], []
    for j in range(4):
        w, dphi = _weights_dense((f + float(j - 1)) - c, kind)
        ws.append(round_bf16(w) if bf16 else w)
        ds.append(round_bf16(-dphi) if bf16 else -dphi)
    return f - 1.0, ws, ds


def _linear_weights(fx: torch.Tensor, bf16: bool):
    """The two linear tap weights (1 - f, f) of fractions f, with `bf16`
    rounded to bfloat16."""
    lo, hi = 1.0 - fx, fx
    return (round_bf16(lo), round_bf16(hi)) if bf16 else (lo, hi)


def _linear_sum(v00, v01, v10, v11, fx, fy, need_grad: bool, bf16: bool):
    """The dense linear sample from its 2x2 taps and fractions: the value
    and, with `need_grad`, its derivatives (0 along an axis at an exactly
    integer coordinate)."""
    wx0, wx1 = _linear_weights(fx, bf16)
    wy0, wy1 = _linear_weights(fy, bf16)
    top = v00 * wx0 + v01 * wx1
    bot = v10 * wx0 + v11 * wx1
    val = top * wy0 + bot * wy1
    if not need_grad:
        return val, None, None
    zero = torch.zeros_like(val)
    dx = torch.where(fx > 0, (v01 - v00) * wy0 + (v11 - v10) * wy1, zero)
    dy = torch.where(fy > 0, bot - top, zero)
    return val, dx, dy


def _cubic_sum(tap, wx, dwx, wy, dwy, need_grad: bool):
    """Value and derivatives from the 4x4 taps (`tap(r, j)`: row r,
    column j), each row summed first, as the dense contractions do."""
    rows = [sum(tap(r, j) * wx[j] for j in range(4)) for r in range(4)]
    val = sum(rows[r] * wy[r] for r in range(4))
    if not need_grad:
        return val, None, None
    rows_dx = [sum(tap(r, j) * dwx[j] for j in range(4)) for r in range(4)]
    return (val, sum(rows_dx[r] * wy[r] for r in range(4)),
            sum(rows[r] * dwy[r] for r in range(4)))


def sample_windows(win, x: torch.Tensor, y: torch.Tensor,
                   need_grad: bool = False, kind: str = LINEAR,
                   bf16: bool = False):
    """Dense-convention values of per-tracker windows: win (B, Hc, Wc)
    or, with C channels, (B, C, Hc, Wc) at window coordinates x, y
    (B, N) -> (B, N) or (B, C, N). Coordinates are clamped to the dense
    bounds of `kind` (linear, cubic, cubic_bspl) in each window, as
    `sample(window, pts, kind + "_mm")` does for one window. With
    `need_grad`, returns (val, dx, dy), the derivatives by the dense
    convention (linear: 0 along an axis at an exactly integer
    coordinate). `bf16`: bfloat16 window values and tap weights, float32
    sums (`interp_bf16`)."""
    lo, hi = _clamp_margins(kind)
    gray = win.dim() == 3
    if gray:
        win = win[:, None]
    b, c, hc, wc = win.shape
    if bf16:
        win = round_bf16(win)
    cx = _clamp_st(x, lo, wc - hi)
    cy = _clamp_st(y, lo, hc - hi)
    flat = win.reshape(b, c, hc * wc)
    if kind == LINEAR:
        fxs, fys = torch.floor(cx), torch.floor(cy)
        fx = _frac_dense(cx - fxs)[:, None]
        fy = _frac_dense(cy - fys)[:, None]
        # (the clamp keeps a NaN coordinate's taps inside: its value is
        # NaN, as the JAX package's, not an out-of-bounds read)
        i00 = (fys.long() * wc + fxs.long()).clamp(0, (hc - 1) * wc - 2)
        idx = torch.cat([i00, i00 + 1, i00 + wc, i00 + wc + 1], dim=-1)
        taps = flat.gather(2, idx[:, None].expand(b, c, idx.shape[-1]))
        val, dx, dy = _linear_sum(*taps.chunk(4, dim=-1), fx, fy, need_grad,
                                  bf16)
    else:
        x0, wx, dwx = _cubic_axis(cx, kind, bf16)
        y0, wy, dwy = _cubic_axis(cy, kind, bf16)
        base = (y0.long() * wc + x0.long()).clamp(
            0, (hc - 4) * wc + wc - 4)                      # (B, N)
        n = base.shape[-1]
        idx = torch.cat([base + (r * wc + j) for r in range(4)
                         for j in range(4)], dim=-1)        # (B, 16 N)
        taps = flat.gather(2, idx[:, None].expand(b, c, 16 * n)).reshape(
            b, c, 4, 4, n)
        val, dx, dy = _cubic_sum(
            lambda r, j: taps[:, :, r, j], *[
                [t[:, None] for t in ts] for ts in (wx, dwx, wy, dwy)],
            need_grad=need_grad)
    if gray:
        val = val[:, 0]
        if need_grad:
            dx, dy = dx[:, 0], dy[:, 0]
    return (val, dx, dy) if need_grad else val


def sample_dense(img, pts: torch.Tensor, kind: str = LINEAR,
                 crop: int | None = None, cval: float = 0.0,
                 need_grad: bool = True, bf16: bool = False,
                 precision: str | None = None):
    """Dense-convention sampling with `kind` taps (linear, cubic,
    cubic_bspl) -> (patch (..., N, C), grad (..., N, C, 2) | None).

    `crop`: window size; each batch element's window starts at
    floor(min(pts)) - 2 (clipped into the image), and coordinates are
    clamped to that window, as `jax.lax.dynamic_slice` plus the dense
    clamp do in the JAX package. The window is never materialised.
    `cval` is ignored, as in the JAX package (the border is replicate).
    `bf16`: bfloat16 image values and tap weights, float32 sums (the JAX
    package's `compute_dtype=bfloat16`). `precision` is the JAX package's
    `interp_precision` ("highest": full float32 contractions instead of
    the TPU's default bf16 passes); this sampler has no matmul and no
    TF32, only float32 gathers and products, so every setting computes
    what "highest" does."""
    del cval, precision
    lo, hi = _clamp_margins(kind)
    x, y = pts[..., 0], pts[..., 1]
    img_flat, h, w, c, base = _flat(img, x)

    def tap(xi, yi):
        v = _gather(img_flat, base, h, w, xi, yi)
        return round_bf16(v) if bf16 else v

    if crop is not None and (crop < h or crop < w):
        hc, wc = min(crop, h), min(crop, w)
        ox = crop_origin(x, wc, w, 2.0)[..., None]
        oy = crop_origin(y, hc, h, 2.0)[..., None]
    else:
        hc, wc = h, w
        ox = oy = torch.zeros((), dtype=x.dtype, device=x.device)
    cx = _clamp_st(x - ox, lo, wc - hi)
    cy = _clamp_st(y - oy, lo, hc - hi)
    if kind != LINEAR:
        x0, wx, dwx = _cubic_axis(cx, kind, bf16)
        y0, wy, dwy = _cubic_axis(cy, kind, bf16)
        xi, yi = (x0 + ox).long(), (y0 + oy).long()
        val, dx, dy = _cubic_sum(
            lambda r, j: tap(xi + j, yi + r), *[
                [t[..., None] for t in ts] for ts in (wx, dwx, wy, dwy)],
            need_grad=need_grad)
        return val, (torch.stack([dx, dy], dim=-1) if need_grad else None)
    fxs, fys = torch.floor(cx), torch.floor(cy)
    fx = _frac_dense(cx - fxs)[..., None]
    fy = _frac_dense(cy - fys)[..., None]
    xi = (fxs + ox).long()
    yi = (fys + oy).long()
    val, dx, dy = _linear_sum(tap(xi, yi), tap(xi + 1, yi),
                              tap(xi, yi + 1), tap(xi + 1, yi + 1), fx, fy,
                              need_grad, bf16)
    return val, (torch.stack([dx, dy], dim=-1) if need_grad else None)


def sample_dense_parts(img, pts: torch.Tensor, kind: str = LINEAR,
                       crop: int | None = None, cval: float = 0.0,
                       bf16: bool = False):
    """`sample_dense` with its derivative unstacked -> (val, dx, dy), each
    (..., N, C)."""
    val, grad = sample_dense(img, pts, kind, crop, cval, bf16=bf16)
    return val, grad[..., 0], grad[..., 1]


def _tiles(pts: torch.Tensor, grid_shape, blocks):
    """Points (..., ry·rx, 2) of a row-major (y outer) grid as the
    `blocks` (by, bx) row-major tiles (..., by·bx, bh·bw, 2)."""
    by, bx = blocks
    ry, rx = grid_shape
    if ry % by or rx % bx:
        raise ValueError(f"grid {tuple(grid_shape)} not divisible by "
                         f"{tuple(blocks)}")
    if pts.shape[-2] != ry * rx:
        # (a coarse phase's decimated grid: the JAX package's reshape
        # raises there too)
        raise ValueError(f"{pts.shape[-2]} points are not the {ry}x{rx} "
                         "grid the tiles split")
    bh, bw = ry // by, rx // bx
    lead = pts.shape[:-2]
    k = len(lead)
    p = pts.reshape(lead + (by, bh, bx, bw) + pts.shape[-1:])
    return p.permute(*range(k), k, k + 2, k + 1, k + 3, k + 4).reshape(
        lead + (by * bx, bh * bw) + pts.shape[-1:])


def _untile(t: torch.Tensor, grid_shape, blocks, tail: int):
    """`_tiles`' inverse on per-tile values (..., by·bx, bh·bw, *tail)
    with `tail` trailing dims -> (..., ry·rx, *tail)."""
    by, bx = blocks
    ry, rx = grid_shape
    bh, bw = ry // by, rx // bx
    lead = t.shape[:-2 - tail]
    rest = t.shape[t.dim() - tail:]
    k = len(lead)
    u = t.reshape(lead + (by, bx, bh, bw) + rest)
    return u.permute(*range(k), k, k + 2, k + 1, k + 3,
                     *range(k + 4, u.dim())).reshape(lead + (ry * rx,)
                                                     + rest)


def sample_dense_blocked(img, pts: torch.Tensor, kind: str = LINEAR,
                         crop: int = 64, grid_shape=(50, 50),
                         blocks=(2, 2), bf16: bool = False):
    """Tiled dense sampling (`mtf_tpu/ops/interp.py:sample_dense_blocked`):
    the row-major (resy, resx) point grid pts (..., N, 2) split into the
    `blocks` (by, bx) row-major tiles, each sampled by `sample_dense` in
    its own `crop` window (anchored at the tile's own points), the
    results put back in grid order -> (patch (..., N, C), grad
    (..., N, C, 2)). A grid that the blocks do not divide raises
    ValueError."""
    tiles = _tiles(pts, grid_shape, blocks)
    val, grad = sample_dense(img, tiles, kind, crop=crop, bf16=bf16)
    return (_untile(val, grid_shape, blocks, 1),
            _untile(grad, grid_shape, blocks, 2))
