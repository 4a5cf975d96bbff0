"""Image patch sampling (port of `mtf_tpu/ops/interp.py`).

Images are (H, W) or (H, W, C) float tensors; points are (..., N, 2) in
(x, y) order with any leading batch dims; patches are (..., N, C).
Border handling is 'replicate' (the slice's only border mode).

`sample_dense` keeps the JAX dense ("*_mm") conventions exactly, while
reading the taps by gather instead of the TPU's tap-weight matmuls:
  * coordinates are clamped to [0.001, size - 1.001] of the (cropped)
    window, which makes the replicate border and keeps all 4 taps inside;
  * the derivative is the dense kernel's phi'(t) = -sign(t) for |t| < 1,
    so at an exactly integer coordinate the derivative along that axis
    is 0, not the one-sided difference a gather form would give.
"""
from __future__ import annotations

import torch

LINEAR = "linear"
CUBIC = "cubic"            # Catmull-Rom
LINEAR_MM = "linear_mm"
REPLICATE = "replicate"


def _as_hwc(img: torch.Tensor) -> torch.Tensor:
    return img[..., None] if img.dim() == 2 else img


def _gather(img_flat: torch.Tensor, h: int, w: int, xi: torch.Tensor,
            yi: torch.Tensor) -> torch.Tensor:
    """Pixel values at integer coords (...,) -> (..., C), replicate
    border."""
    xc = xi.clamp(0, w - 1)
    yc = yi.clamp(0, h - 1)
    return img_flat[yc * w + xc]


def _cubic_weights(f: torch.Tensor):
    """Catmull-Rom 4-tap weights for offsets f in [0, 1)."""
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (-f + 2.0 * f2 - f3), 0.5 * (2.0 - 5.0 * f2 + 3.0 * f3),
            0.5 * (f + 4.0 * f2 - 3.0 * f3), 0.5 * (-f2 + f3))


def sample(img: torch.Tensor, pts: torch.Tensor, kind: str = LINEAR,
           border: str = REPLICATE) -> torch.Tensor:
    """Sample img at subpixel points -> patch (..., N, C)."""
    if border != REPLICATE:
        raise NotImplementedError(
            f"border {border!r} is not ported yet: ROADMAP Queue 1, slice 8")
    if kind == LINEAR_MM:
        return sample_dense(img, pts, LINEAR, need_grad=False)[0]
    img = _as_hwc(img)
    h, w, c = img.shape
    img_flat = img.reshape(h * w, c)
    x, y = pts[..., 0], pts[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    if kind == LINEAR:
        v00 = _gather(img_flat, h, w, x0, y0)
        v01 = _gather(img_flat, h, w, x0 + 1, y0)
        v10 = _gather(img_flat, h, w, x0, y0 + 1)
        v11 = _gather(img_flat, h, w, x0 + 1, y0 + 1)
        top = v00 * (1.0 - fx) + v01 * fx
        bot = v10 * (1.0 - fx) + v11 * fx
        return top * (1.0 - fy) + bot * fy
    if kind == CUBIC:
        wx = _cubic_weights(fx)
        wy = _cubic_weights(fy)
        rows = [sum(_gather(img_flat, h, w, x0 + i - 1, y0 + j - 1) * wx[i]
                    for i in range(4)) for j in range(4)]
        return sum(rows[j] * wy[j] for j in range(4))
    raise NotImplementedError(
        f"interp {kind!r} is not ported yet: ROADMAP Queue 1, slice 4")


def crop_origin(pts: torch.Tensor, size: int, full: int,
                margin: float) -> torch.Tensor:
    """Window start per batch element along one axis: floor(min) - margin,
    clipped to [0, full - size]. pts: (..., N) coordinates -> (...,)."""
    return torch.clamp(torch.floor(pts.amin(dim=-1)) - margin, 0.0,
                       float(full - size))


def sample_windows(win: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   need_grad: bool = False):
    """Dense-convention linear values of per-tracker windows: win
    (B, Hc, Wc) at window coordinates x, y (B, N) -> (B, N). Coordinates
    are clamped to [0.001, size - 1.001] of each window, as
    `sample(window, pts, "linear_mm")` does for one window. With
    `need_grad`, returns (val, dx, dy), the derivatives by the dense
    convention (0 along an axis at an exactly integer coordinate)."""
    b, hc, wc = win.shape
    cx = torch.clamp(x, 0.001, wc - 1.001)
    cy = torch.clamp(y, 0.001, hc - 1.001)
    fxs, fys = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - fxs, cy - fys
    i00 = fys.long() * wc + fxs.long()
    taps = win.reshape(b, hc * wc).gather(
        1, torch.cat([i00, i00 + 1, i00 + wc, i00 + wc + 1], dim=-1))
    v00, v01, v10, v11 = taps.chunk(4, dim=-1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy
    if not need_grad:
        return val
    zero = torch.zeros_like(val)
    dx = torch.where(fx > 0, (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy,
                     zero)
    return val, dx, torch.where(fy > 0, bot - top, zero)


def sample_dense(img: torch.Tensor, pts: torch.Tensor, kind: str = LINEAR,
                 crop: int | None = None, need_grad: bool = True):
    """Dense-convention linear sampling -> (patch (..., N, C),
    grad (..., N, C, 2) | None).

    `crop`: window size; each batch element's window starts at
    floor(min(pts)) - 2 (clipped into the image), and coordinates are
    clamped to that window, as `jax.lax.dynamic_slice` plus the dense
    clamp do in the JAX package. The window is never materialised."""
    if kind != LINEAR:
        raise NotImplementedError(
            f"dense interp {kind!r} is not ported yet: ROADMAP Queue 1, "
            "slice 4")
    img = _as_hwc(img)
    h, w, c = img.shape
    x, y = pts[..., 0], pts[..., 1]
    if crop is not None and (crop < h or crop < w):
        hc, wc = min(crop, h), min(crop, w)
        ox = crop_origin(x, wc, w, 2.0)[..., None]
        oy = crop_origin(y, hc, h, 2.0)[..., None]
    else:
        hc, wc = h, w
        ox = oy = torch.zeros((), dtype=x.dtype, device=x.device)
    cx = torch.clamp(x - ox, 0.001, wc - 1.001)
    cy = torch.clamp(y - oy, 0.001, hc - 1.001)
    fxs, fys = torch.floor(cx), torch.floor(cy)
    fx, fy = (cx - fxs)[..., None], (cy - fys)[..., None]
    xi = (fxs + ox).long()
    yi = (fys + oy).long()
    img_flat = img.reshape(h * w, c)
    v00 = _gather(img_flat, h, w, xi, yi)
    v01 = _gather(img_flat, h, w, xi + 1, yi)
    v10 = _gather(img_flat, h, w, xi, yi + 1)
    v11 = _gather(img_flat, h, w, xi + 1, yi + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy
    if not need_grad:
        return val, None
    dx = torch.where(fx > 0, (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy,
                     torch.zeros_like(val))
    dy = torch.where(fy > 0, bot - top, torch.zeros_like(val))
    return val, torch.stack([dx, dy], dim=-1)
