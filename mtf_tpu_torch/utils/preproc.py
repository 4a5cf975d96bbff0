"""Frame preprocessing chain (port of `mtf_tpu/utils/preproc.py`).

The reference's preprocessing keys (raw none gauss med box bil aniso
sobel, histogram equalization, and the descriptor fields of DFT) on
(H, W[, C]) float32 frames. The filters are cross-correlations with zero
padding, as `lax.conv_general_dilated` computes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def to_gray(frame: torch.Tensor) -> torch.Tensor:
    """RGB -> luminance (reference dtype/channel conversion)."""
    if frame.dim() == 2:
        return frame
    if frame.shape[-1] == 1:
        return frame[..., 0]
    return frame @ torch.tensor([0.299, 0.587, 0.114], dtype=frame.dtype,
                                device=frame.device)


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' cross-correlation of (H, W[, C]) with kernel
    (kh, kw), zero padding."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    c = x.shape[-1]
    kh, kw = kernel.shape
    k = kernel.to(x.dtype).expand(c, 1, kh, kw)
    y = F.conv2d(x.movedim(-1, 0)[None], k, padding=(kh // 2, kw // 2),
                 groups=c)
    y = y[0].movedim(0, -1)
    return y[..., 0] if squeeze else y


def _gaussian_taps(size: int, sigma: float, device=None) -> torch.Tensor:
    """The normalised 1D Gaussian taps (size,) of `gaussian_kernel`."""
    r = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-r * r / (2 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_kernel(size: int = 5, sigma: float = 1.0,
                    device=None) -> torch.Tensor:
    k = _gaussian_taps(size, sigma, device)
    return k[:, None] * k[None, :]


def gaussian_filter(frame: torch.Tensor, size: int = 5,
                    sigma: float = 1.0) -> torch.Tensor:
    return _conv2(frame, gaussian_kernel(size, sigma, frame.device))


def box_filter(frame: torch.Tensor, size: int = 3) -> torch.Tensor:
    return _conv2(frame, torch.full((size, size), 1.0 / (size * size),
                                    device=frame.device))


def _edge_views(x: torch.Tensor, size: int):
    """The size x size shifted views of (H, W, C) with replicate edges."""
    h, w, _ = x.shape
    pad = size // 2
    xp = F.pad(x.movedim(-1, 0)[None], (pad, pad, pad, pad),
               mode="replicate")[0].movedim(0, -1)
    return [xp[i:i + h, j:j + w] for i in range(size) for j in range(size)]


def median_filter(frame: torch.Tensor, size: int = 3) -> torch.Tensor:
    squeeze = frame.dim() == 2
    x = frame[..., None] if squeeze else frame
    # the median of an odd count of views (the JAX package's jnp.median)
    y = torch.stack(_edge_views(x, size)).median(dim=0).values
    return y[..., 0] if squeeze else y


def sobel_filter(frame: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude (reference sobel preproc)."""
    kx = torch.tensor(_SOBEL_X, device=frame.device)
    gx = _conv2(frame, kx)
    gy = _conv2(frame, kx.T)
    return torch.sqrt(gx * gx + gy * gy)


def _sep_corr(x: torch.Tensor, col, row) -> torch.Tensor:
    """'Same' cross-correlation of x (..., H, W) with the separable kernel
    col ⊗ row, zero padding, as shift-adds in float32: along rows first,
    then along columns, zero taps skipped. Every element is the same sum
    whatever the batch (no convolution algorithm chosen by shape, no TF32
    on the card)."""
    h, w = x.shape[-2:]
    rr, rc = len(row) // 2, len(col) // 2
    xp = F.pad(x, (rr, rr, 0, 0))
    t = sum(float(c) * xp[..., :, j:j + w] for j, c in enumerate(row) if c)
    tp = F.pad(t, (0, 0, rc, rc))
    return sum(float(c) * tp[..., i:i + h, :] for i, c in enumerate(col)
               if c)


def descriptor_fields(frame: torch.Tensor, sigma: float = 1.5,
                      batched: bool = False) -> torch.Tensor:
    """Descriptor Fields (Crivellaro & Lepetit, CVPR'14; the reference's
    `ThirdParty/DFT`): the image gradient split into its positive and
    negative x and y parts, each Gaussian-smoothed -> (H, W, 4). Tracking
    DFT is any LK SM on this 4-channel frame. With `batched`, frames
    (B, H, W[, C]) -> (B, H, W, 4) in one pass: one Sobel pair and one
    Gaussian over the whole batch. The JAX package's 2D convolutions
    (`mtf_tpu/utils/preproc.py:80`) are applied here as their separable
    factors (Sobel/8 = [1, 2, 1] x [-1, 0, 1] / 8, the Gaussian k x k), so
    a frame's fields do not depend on the batch it is in."""
    if not batched:
        return descriptor_fields(frame[None], sigma, batched=True)[0]
    g = frame
    if g.dim() == 4:
        g = g[..., 0] if g.shape[-1] == 1 else to_gray(g)
    gx = _sep_corr(g, (1.0, 2.0, 1.0), (-0.125, 0.0, 0.125))
    gy = _sep_corr(g, (-0.125, 0.0, 0.125), (1.0, 2.0, 1.0))
    parts = torch.stack([torch.clamp(gx, min=0.0), torch.clamp(-gx, min=0.0),
                         torch.clamp(gy, min=0.0), torch.clamp(-gy, min=0.0)],
                        dim=-3)                            # (B, 4, H, W)
    k = _gaussian_taps(int(2 * round(2 * sigma) + 1), sigma).tolist()
    return _sep_corr(parts, k, k).movedim(-3, -1)


def bilateral_filter(frame: torch.Tensor, size: int = 5,
                     sigma_s: float = 2.0,
                     sigma_r: float = 25.0) -> torch.Tensor:
    squeeze = frame.dim() == 2
    x = frame[..., None] if squeeze else frame
    pad = size // 2
    acc = torch.zeros_like(x)
    norm = torch.zeros_like(x)
    views = _edge_views(x, size)
    for i in range(size):
        for j in range(size):
            shift = views[i * size + j]
            ds2 = (i - pad) ** 2 + (j - pad) ** 2
            ws = torch.exp(torch.tensor(-ds2 / (2 * sigma_s * sigma_s),
                                        dtype=x.dtype))
            wr = torch.exp(-(shift - x) ** 2 / (2 * sigma_r * sigma_r))
            wgt = ws.to(x.device) * wr
            acc = acc + wgt * shift
            norm = norm + wgt
    y = acc / torch.clamp(norm, min=1e-12)
    return y[..., 0] if squeeze else y


def anisotropic_diffusion(frame: torch.Tensor, n_iters: int = 5,
                          kappa: float = 30.0,
                          lam: float = 0.25) -> torch.Tensor:
    """Perona-Malik diffusion (reference aniso preproc)."""
    def g(d):
        return torch.exp(-(d / kappa) ** 2)

    u = frame
    for _ in range(n_iters):
        dn = torch.roll(u, 1, 0) - u
        ds = torch.roll(u, -1, 0) - u
        de = torch.roll(u, -1, 1) - u
        dw = torch.roll(u, 1, 1) - u
        u = u + lam * (g(dn) * dn + g(ds) * ds + g(de) * de + g(dw) * dw)
    return u


def hist_equalize(frame: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Histogram equalization over [0, 255]; the bins as `jnp.histogram`
    counts them (searchsorted right on the edges, the top edge in the
    last bin)."""
    flat = frame.reshape(-1)
    edges = torch.linspace(0.0, 255.0, n_bins + 1, device=frame.device)
    b = torch.searchsorted(edges, flat.contiguous(), right=True)
    b = torch.where(flat == edges[-1], n_bins, b)
    hist = torch.zeros(n_bins + 2, dtype=torch.float32,
                       device=frame.device).index_add_(
        0, b, torch.ones_like(flat))[1:n_bins + 1]
    cdf = torch.cumsum(hist, 0)
    cdf = (cdf - cdf[0]) / torch.clamp(cdf[-1] - cdf[0], min=1e-12) * 255.0
    idx = torch.clamp((flat / 255.0 * (n_bins - 1)).to(torch.int64), 0,
                      n_bins - 1)
    return cdf[idx].reshape(frame.shape)


PREPROC_REGISTRY = {
    "raw": lambda f: f,
    "none": to_gray,
    "gauss": lambda f: gaussian_filter(to_gray(f)),
    "med": lambda f: median_filter(to_gray(f)),
    "box": lambda f: box_filter(to_gray(f)),
    "bil": lambda f: bilateral_filter(to_gray(f)),
    "aniso": lambda f: anisotropic_diffusion(to_gray(f)),
    "sobel": lambda f: sobel_filter(to_gray(f)),
    "hist_eq": lambda f: hist_equalize(to_gray(f)),
    "dft": descriptor_fields,
}


def get_preproc(key: str = "none"):
    """Reference `getPreProc` (pipeline.h:178-247)."""
    k = key.lower()
    if k not in PREPROC_REGISTRY:
        raise ValueError(f"unknown preproc {key!r}; known: "
                         f"{sorted(PREPROC_REGISTRY)}")
    return PREPROC_REGISTRY[k]
