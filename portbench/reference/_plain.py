"""Plain PyTorch helpers the references share: homogeneous warps, the
4-point homography, dense-convention linear sampling in a window, the
crop rule and the binomial blur. Float32 throughout, except the 4-point
solve (float64); the harness runs them with TF32 off. Imports nothing
of the program."""
from __future__ import annotations

import numpy as np
import torch

# the 8-DOF homography's generators: W(p) = I + sum_i p_i G_i over
# (tx, ty, h00 - 1, h01, h10, h11 - 1, h20, h21)
HOM_ENTRIES = ((0, 2), (1, 2), (0, 0), (0, 1), (1, 0), (1, 1), (2, 0),
               (2, 1))


def generators(device) -> torch.Tensor:
    g = torch.zeros((8, 3, 3), dtype=torch.float32, device=device)
    for i, (r, c) in enumerate(HOM_ENTRIES):
        g[i, r, c] = 1.0
    return g


def apply(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """dehom(H @ hom(p)): h (M, 3, 3), pts (M, K, 2) -> (M, K, 2)."""
    q = (h[:, None, :, :2] * pts[:, :, None, :]).sum(-1) + h[:, None, :, 2]
    return q[..., :2] / q[..., 2:3]


def four_point(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) float32 homographies, h22 = 1, taking the 4 points src
    (M, 4, 2) to dst (M, 4, 2): the 8x8 system solved in float64."""
    s, d = src.double(), dst.double()
    x, y, u, v = s[..., 0], s[..., 1], d[..., 0], d[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    a = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    h = torch.linalg.solve(a, torch.cat([u, v], -1))
    return torch.cat([h, torch.ones_like(h[:, :1])], -1).reshape(
        -1, 3, 3).float()


def norm_frame(corners: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) similarity from the template frame (centroid 0, unit
    mean corner distance) to the image, from init corners (M, 4, 2)."""
    c = corners.mean(-2)
    s = torch.clamp(torch.linalg.vector_norm(corners - c[:, None], dim=-1)
                    .mean(-1), min=1e-6)
    t = torch.zeros((corners.shape[0], 3, 3), dtype=corners.dtype,
                    device=corners.device)
    t[:, 0, 0] = t[:, 1, 1] = s
    t[:, :2, 2] = c
    t[:, 2, 2] = 1.0
    return t


def inv_norm(t: torch.Tensor) -> torch.Tensor:
    """The inverse of `norm_frame`'s similarities."""
    out = torch.zeros_like(t)
    s = t[:, 0, 0]
    out[:, 0, 0] = out[:, 1, 1] = 1.0 / s
    out[:, :2, 2] = -t[:, :2, 2] / s[:, None]
    out[:, 2, 2] = 1.0
    return out


def state_from_corners(norm: torch.Tensor, base_corners: torch.Tensor,
                       corners: torch.Tensor) -> torch.Tensor:
    """The template-frame warp (M, 3, 3), h22 = 1, that puts the base
    corners on image corners (M, 4, 2)."""
    return four_point(base_corners, apply(inv_norm(norm), corners))


def crop_origin(v: torch.Tensor, size: int, full: int,
                margin: float) -> torch.Tensor:
    """A window's start along one axis: floor(min v) - margin, clipped to
    [0, full - size] (NaN to 0); v (M, K) -> (M,)."""
    return torch.clamp(torch.nan_to_num(torch.floor(v.amin(-1)) - margin,
                                        nan=0.0), 0.0, float(full - size))


def sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           x0: torch.Tensor, y0: torch.Tensor, hc: int, wc: int,
           need_grad: bool = True):
    """Linear samples of images img (M, H, W) at image coordinates x, y
    (M, K), in the window of size (hc, wc) at (x0, y0) (M,): coordinates
    clamped to [0.001, size - 1.001] of the window, the 2x2 taps read by
    gather; the derivative along an axis is 0 at an exactly integer
    coordinate. -> val, dx, dy (M, K)."""
    m, h, w = img.shape
    cx = torch.clamp(x - x0[:, None], 0.001, wc - 1.001)
    cy = torch.clamp(y - y0[:, None], 0.001, hc - 1.001)
    fxs, fys = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - fxs, cy - fys
    i00 = ((fys + y0[:, None]).long() * w + (fxs + x0[:, None]).long())
    i00 = i00.clamp(0, (h - 1) * w - 2)
    flat = img.reshape(m, h * w)
    v00, v01 = flat.gather(1, i00), flat.gather(1, i00 + 1)
    v10, v11 = flat.gather(1, i00 + w), flat.gather(1, i00 + w + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy
    if not need_grad:
        return val, None, None
    zero = torch.zeros_like(val)
    dx = torch.where(fx > 0, (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy,
                     zero)
    dy = torch.where(fy > 0, bot - top, zero)
    return val, dx, dy


def sample_full(img: torch.Tensor, pts: torch.Tensor, need_grad=False):
    """`sample` over the whole image (no window): pts (M, K, 2)."""
    m, h, w = img.shape
    z = torch.zeros((m,), dtype=pts.dtype, device=pts.device)
    return sample(img, pts[..., 0], pts[..., 1], z, z, h, w, need_grad)


def binomial(stride: int) -> np.ndarray:
    """The 2 (stride - 1) + 1 binomial taps of a stride's low-pass."""
    k = np.array([1.0])
    for _ in range(2 * (stride - 1)):
        k = np.convolve(k, [0.5, 0.5])
    return k.astype(np.float32)


def blur(img: torch.Tensor, stride: int) -> torch.Tensor:
    """Separable binomial blur of images (M, H, W), the edge replicated,
    as float32 shift-adds (rows, then columns)."""
    if stride <= 1:
        return img
    k = binomial(stride)
    r = (len(k) - 1) // 2
    m, h, w = img.shape
    f = torch.nn.functional.pad(img[:, None], (r, r, r, r),
                                mode="replicate")[:, 0]
    fh = sum(float(k[i]) * f[:, :, i:i + w] for i in range(len(k)))
    return sum(float(k[j]) * fh[:, j:j + h] for j in range(len(k)))
