"""Correlation-filter trackers (MOSSE, KCF, DSST; port of
`mtf_tpu/sm/cf.py`) over a leading batch of B trackers.

Every filter lives in the Fourier domain (`torch.fft` over the filter
plane of (B, res, res, C) features): MOSSE's adaptive filter
num / den, KCF's kernelized ridge regression with a Gaussian kernel by
circular cross-correlation, DSST's translation filter plus a 1-D filter
over a geometric pyramid of 17 scales (the JAX `vmap` over the scale
factors is a (B, S) batch of windows). Features are the normalized-log
gray plane (`features="gray"`) or fHOG channels plus the gray plane
(`"hog"`, `ops/hog.py`). Each update measures the response's
peak-to-sidelobe ratio (PSR) and, with `psr_thresh > 0`, skips the filter
update below it.

The trackers are axis-aligned-box learners with no SSM: `corners` reports
the box as 4 corners, (B, 2, 4) as every search method of the port. The
only frame reads are window samples (`_grab`), so `update_multi` takes
per-tracker frames (B, H, W[, C]).

The module's helpers (`_window_pts`, `_grab`, `_corners_of`,
`_center_size_of`, ...) are the JAX module's, batched; `sm/learn.py` and
`sm/tld.py` import them as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from mtf_tpu_torch import _device
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.hog import cell_pool, hog
from mtf_tpu_torch.sm.core import multi_frames


# ---------------------------------------------------------------------------
# shared configuration and helpers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CFParams:
    res: int = 64                  # translation-filter sample resolution
    padding: float = 2.0           # search window = padding * target size
    lr: float = 0.025              # filter learning rate (interp_factor)
    lam: float = 1e-4              # ridge regularizer
    output_sigma_factor: float = 1.0 / 16.0   # label sigma vs window size
    kernel_sigma: float = 0.2      # KCF Gaussian-kernel bandwidth
    n_scales: int = 17             # DSST scale-pyramid size (odd)
    scale_step: float = 1.02       # DSST geometric scale factor
    scale_res: int = 16            # DSST per-scale feature resolution
    scale_lr: float = 0.025
    scale_sigma: float = 1.0       # DSST scale-label sigma (in scale steps)
    scale_max_ratio: float = 4.0   # clamp on total scale drift
    features: str = "gray"         # "gray" | "hog" (fHOG + gray channels)
    cell: int = 2                  # hog: sampled px per filter cell
    n_orient: int = 9              # hog orientation bins (channels = 3n+5)
    psr_thresh: float = 0.0        # skip filter update when PSR below
    psr_guard: int = 5             # PSR sidelobe exclusion radius (px)


def _window_pts(center: torch.Tensor, sz: torch.Tensor,
                res: int) -> torch.Tensor:
    """(..., res·res, 2) xy sampling grids of axis-aligned windows at
    centers and sizes (..., 2)."""
    t = (torch.arange(res, dtype=torch.float32, device=center.device)
         + 0.5) / res - 0.5
    gx = center[..., 0, None] + t * sz[..., 0, None]       # (..., res)
    gy = center[..., 1, None] + t * sz[..., 1, None]
    lead = center.shape[:-1]
    xx = gx[..., None, :].expand(lead + (res, res))
    yy = gy[..., :, None].expand(lead + (res, res))
    return torch.stack([xx, yy], dim=-1).reshape(lead + (res * res, 2))


def _grab(frame: torch.Tensor, center: torch.Tensor, sz: torch.Tensor,
          res: int) -> torch.Tensor:
    """The windows as (..., res, res) gray patches (bilinear, replicate
    border, the mean of the channels); a per-tracker stack (B, H, W, C)
    is read at each tracker's own window."""
    p = interp.sample(frame, _window_pts(center, sz, res), "linear",
                      "replicate")
    return p.mean(dim=-1).reshape(center.shape[:-1] + (res, res))


def _hann2(res: int, device=None) -> torch.Tensor:
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * (
        torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res)
    return torch.outer(w, w)


def _gray_plane(patch: torch.Tensor) -> torch.Tensor:
    """MOSSE preprocessing of (..., res, res) patches: log-scale,
    zero-mean, unit-norm (Bolme et al. §3.1); the caller windows it."""
    p = torch.log1p(torch.clamp(patch, min=0.0))
    p = p - p.mean(dim=(-2, -1), keepdim=True)
    return p / (torch.linalg.vector_norm(p, dim=(-2, -1), keepdim=True)
                + 1e-6)


def _gauss_label(res: int, sigma: float, device=None) -> torch.Tensor:
    """Wrapped 2-D Gaussian peaked at index (0, 0) (fftshift-free)."""
    r = torch.arange(res, dtype=torch.float32, device=device)
    d = torch.remainder(r + res / 2.0, res) - res / 2.0
    g = torch.exp(-0.5 * (d ** 2) / (sigma ** 2))
    return torch.outer(g, g)


def _wrap_disp(idx: torch.Tensor, res: int) -> torch.Tensor:
    return torch.remainder(idx.to(torch.float32) + res / 2.0, res) - res / 2.0


def _argmax_flat(resp: torch.Tensor):
    """(iy, ix) of each (res, res) response's peak (first on a tie, as
    `jnp.argmax` of the flat response)."""
    res = resp.shape[-1]
    flat = resp.flatten(-2).argmax(-1)
    return flat // res, flat % res


def _peak_subpix(resp: torch.Tensor) -> torch.Tensor:
    """(B, 2) (dy, dx) displacement of each response's (B, res, res) peak,
    with per-axis circular quadratic sub-pixel refinement."""
    res = resp.shape[-1]
    iy, ix = _argmax_flat(resp)
    ar = torch.arange(resp.shape[0], device=resp.device)
    c = resp[ar, iy, ix]

    def _off(minus, plus):
        denom = 2.0 * c - minus - plus
        return torch.where(denom.abs() > 1e-8,
                           0.5 * (plus - minus) / (denom + 1e-12),
                           torch.zeros_like(c))

    oy = _off(resp[ar, (iy - 1) % res, ix], resp[ar, (iy + 1) % res, ix])
    ox = _off(resp[ar, iy, (ix - 1) % res], resp[ar, iy, (ix + 1) % res])
    dy = _wrap_disp(iy, res) + torch.clamp(oy, -0.5, 0.5)
    dx = _wrap_disp(ix, res) + torch.clamp(ox, -0.5, 0.5)
    return torch.stack([dy, dx], dim=-1)


def _psr(resp: torch.Tensor, guard: int) -> torch.Tensor:
    """(B,) peak-to-sidelobe ratios (Bolme §5): (peak - mu_side) /
    sigma_side, the sidelobe everything outside a (2·guard+1)^2 wrapped
    window around the peak."""
    res = resp.shape[-1]
    iy, ix = _argmax_flat(resp)
    r = torch.arange(res, device=resp.device)
    dy = torch.abs(torch.remainder(r - iy[:, None] + res // 2, res)
                   - res // 2)
    dx = torch.abs(torch.remainder(r - ix[:, None] + res // 2, res)
                   - res // 2)
    side = ((dy[:, :, None] > guard) | (dx[:, None, :] > guard)).to(
        resp.dtype)
    n = torch.clamp(side.sum(dim=(-2, -1)), min=1.0)
    mu = (resp * side).sum(dim=(-2, -1)) / n
    var = (torch.square(resp - mu[:, None, None]) * side).sum(
        dim=(-2, -1)) / n
    ar = torch.arange(resp.shape[0], device=resp.device)
    return (resp[ar, iy, ix] - mu) / torch.sqrt(var + 1e-12)


_CORNER_SIGNS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def _corners_of(center: torch.Tensor, sz: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) axis-aligned corners ul, ur, lr, ll."""
    h = sz / 2.0
    return torch.stack([center + h * torch.tensor(s, device=center.device)
                        for s in _CORNER_SIGNS], dim=-2)


def _center_size_of(corners_img: torch.Tensor):
    """Centers and sizes (..., 2) of the bounding boxes of corners
    (..., 4, 2)."""
    c = corners_img.to(torch.float32)
    lo, hi = c.amin(dim=-2), c.amax(dim=-2)
    return (lo + hi) / 2.0, hi - lo


class BoxTracker(nn.Module):
    """Base of the port's axis-aligned-box trackers (the CF family, the
    learn family): the tensors live on `device` (None: the card), corners
    in are (B, 4, 2) and out (B, 2, 4) as for every search method; their
    frame reads are window samples, so `update_multi` steps each tracker
    on its own frame of a (B, H, W[, C]) stack."""

    ssm = None            # bbox tracker: no SSM (like the reference adapters)

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("_anchor", torch.zeros(
            (), device=_device.resolve(device)), persistent=False)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _frame(self, frame) -> torch.Tensor:
        return torch.as_tensor(frame, dtype=torch.float32, device=self.device)

    def _corners_in(self, corners_img) -> torch.Tensor:
        return torch.as_tensor(corners_img, dtype=torch.float32,
                               device=self.device)

    def initialize(self, frame, corners_img):
        """B trackers on one frame from corners (B, 4, 2)."""
        return self._initialize(self._frame(frame),
                                self._corners_in(corners_img))

    def update(self, state, frame):
        return self._update(state, self._frame(frame))

    def update_multi(self, state, frames):
        """One update of the B trackers, each on its own frame: frames
        (B, H, W) or (B, H, W, C)."""
        frames = multi_frames(frames, self.device)
        if frames.shape[0] != state.center.shape[0]:
            raise ValueError(f"{frames.shape[0]} frames for "
                             f"{state.center.shape[0]} trackers")
        return self._update(state, frames)

    def reinitialize(self, frame, corners_img):
        return self.initialize(frame, corners_img)


# ---------------------------------------------------------------------------
# MOSSE
# ---------------------------------------------------------------------------

class MOSSEState(NamedTuple):
    center: torch.Tensor     # (B, 2) xy
    base_sz: torch.Tensor    # (B, 2) target w, h at init
    scale: torch.Tensor      # (B,) current scale (1 for MOSSE and KCF)
    num: torch.Tensor        # (B, res, res, C) complex filter numerator
    den: torch.Tensor        # (B, res, res) real summed denominator
    psr: torch.Tensor        # (B,) last peak-to-sidelobe ratio
    extra: tuple = ()        # the JAX state's empty slot (read nowhere)


class MOSSE(BoxTracker):
    """Minimum output sum of squared error filter (multi-channel)."""

    name = "mosse"

    def __init__(self, prm: CFParams | None = None, device=None):
        super().__init__(device)
        self.prm = prm or CFParams()
        p, dev = self.prm, self.device
        self.register_buffer("_win", _hann2(p.res, dev), persistent=False)
        self.register_buffer("_G", torch.fft.fft2(_gauss_label(
            p.res, p.output_sigma_factor * p.res, dev)), persistent=False)
        self.n_channels = 1 if p.features == "gray" else 3 * p.n_orient + 5

    # -- features -----------------------------------------------------------
    def _feat(self, frame, center, sz) -> torch.Tensor:
        """Windowed feature stacks (B, res, res, C) of the windows."""
        p = self.prm
        if p.features == "hog":
            raw = _grab(frame, center, sz, p.res * p.cell)
            gray = _gray_plane(cell_pool(raw[..., None], p.cell)[..., 0])
            f = torch.cat([hog(raw, p.n_orient, p.cell), gray[..., None]],
                          dim=-1)
        else:
            f = _gray_plane(_grab(frame, center, sz, p.res))[..., None]
        return f * self._win[:, :, None]

    # -- filter algebra -------------------------------------------------------
    def _train_terms(self, feat: torch.Tensor):
        """Per-channel num = G . conj(F_c), one summed den = sum_c F_c .
        conj(F_c); response = ifft2(sum_c num_c . Z_c / (den + lam))."""
        Ff = torch.fft.fft2(feat, dim=(1, 2))
        num = self._G[:, :, None] * torch.conj(Ff)
        den = torch.sum(torch.real(Ff * torch.conj(Ff)), dim=-1)
        return num, den

    def _window_sz(self, st) -> torch.Tensor:
        return st.base_sz * st.scale[:, None] * self.prm.padding

    def _initialize(self, frame, corners_img) -> MOSSEState:
        center, sz = _center_size_of(corners_img)
        b = center.shape[0]
        st = MOSSEState(center=center, base_sz=sz,
                        scale=torch.ones((b,), device=self.device),
                        num=None, den=None,
                        psr=torch.full((b,), math.inf, device=self.device))
        num, den = self._train_terms(self._feat(frame, center,
                                                self._window_sz(st)))
        return st._replace(num=num, den=den)

    def _response(self, st, feat) -> torch.Tensor:
        Z = torch.fft.fft2(feat, dim=(1, 2))
        return torch.real(torch.fft.ifft2(
            torch.sum(st.num * Z, dim=-1) / (st.den + self.prm.lam)))

    def _locate(self, st, frame):
        """(new centers, PSRs) from the response peaks of the current
        filters."""
        wsz = self._window_sz(st)
        resp = self._response(st, self._feat(frame, st.center, wsz))
        d = _peak_subpix(resp)                 # (dy, dx) in filter pixels
        step = wsz / self.prm.res
        center = st.center + torch.stack([d[:, 1] * step[:, 0],
                                          d[:, 0] * step[:, 1]], dim=-1)
        return center, _psr(resp, self.prm.psr_guard)

    def _lr(self, psr: torch.Tensor):
        """The learning rate, zeroed on low-confidence frames (PSR gate):
        a number, or (B,) with the gate."""
        p = self.prm
        if p.psr_thresh <= 0.0:
            return p.lr
        return torch.where(psr >= p.psr_thresh, p.lr, 0.0)

    @staticmethod
    def _mix(old, new, lr):
        if isinstance(lr, torch.Tensor):
            lr = lr.view((-1,) + (1,) * (old.dim() - 1))
        return (1 - lr) * old + lr * new

    def _update(self, st: MOSSEState, frame) -> MOSSEState:
        center, psr = self._locate(st, frame)
        st = st._replace(center=center, psr=psr)
        num, den = self._train_terms(self._feat(frame, center,
                                                self._window_sz(st)))
        lr = self._lr(psr)
        return st._replace(num=self._mix(st.num, num, lr),
                           den=self._mix(st.den, den, lr))

    def corners(self, st) -> torch.Tensor:
        return _corners_of(st.center, st.base_sz * st.scale[:, None]
                           ).transpose(-1, -2)

    def set_region(self, st, corners_img, frame=None):
        center, sz = _center_size_of(self._corners_in(corners_img))
        scale = torch.sqrt(sz.prod(-1) / (st.base_sz.prod(-1) + 1e-12))
        return st._replace(center=center, scale=scale)


# ---------------------------------------------------------------------------
# KCF
# ---------------------------------------------------------------------------

class KCFState(NamedTuple):
    center: torch.Tensor
    base_sz: torch.Tensor
    scale: torch.Tensor
    alpha_f: torch.Tensor    # (B, res, res) complex dual coefficients
    model_x: torch.Tensor    # (B, res, res, C) model template features
    psr: torch.Tensor


def _gauss_corr(xf: torch.Tensor, yf: torch.Tensor,
                sigma: float) -> torch.Tensor:
    """The Gaussian kernel at every circular shift (B, res, res), by the
    Fourier trick (KCF eq. 31, multi-channel eq. 16): channels sum inside
    the cross-correlation; Parseval over the spatial size, the distance
    normalized by the full element count as the KCF code's numel(x)."""
    n_sp = xf.shape[1] * xf.shape[2]
    numel = n_sp * xf.shape[3]
    cross = torch.real(torch.fft.ifft2(torch.sum(xf * torch.conj(yf),
                                                 dim=-1)))
    xx = torch.sum(torch.abs(xf) ** 2, dim=(1, 2, 3)) / n_sp
    yy = torch.sum(torch.abs(yf) ** 2, dim=(1, 2, 3)) / n_sp
    d = torch.clamp((xx + yy)[:, None, None] - 2.0 * cross, min=0.0) / numel
    return torch.exp(-d / (sigma ** 2))


class KCF(MOSSE):
    """Kernelized correlation filter (Gaussian kernel)."""

    name = "kcf"

    def _train(self, feat: torch.Tensor) -> torch.Tensor:
        xf = torch.fft.fft2(feat, dim=(1, 2))
        kf = torch.fft.fft2(_gauss_corr(xf, xf, self.prm.kernel_sigma))
        return self._G / (kf + self.prm.lam)

    def _initialize(self, frame, corners_img) -> KCFState:
        center, sz = _center_size_of(corners_img)
        b = center.shape[0]
        st = KCFState(center=center, base_sz=sz,
                      scale=torch.ones((b,), device=self.device),
                      alpha_f=None, model_x=None,
                      psr=torch.full((b,), math.inf, device=self.device))
        feat = self._feat(frame, center, self._window_sz(st))
        return st._replace(alpha_f=self._train(feat), model_x=feat)

    def _response(self, st, feat) -> torch.Tensor:
        zf = torch.fft.fft2(feat, dim=(1, 2))
        xf = torch.fft.fft2(st.model_x, dim=(1, 2))
        kzf = torch.fft.fft2(_gauss_corr(zf, xf, self.prm.kernel_sigma))
        return torch.real(torch.fft.ifft2(kzf * st.alpha_f))

    def _update(self, st: KCFState, frame) -> KCFState:
        center, psr = self._locate(st, frame)
        st = st._replace(center=center, psr=psr)
        feat = self._feat(frame, center, self._window_sz(st))
        lr = self._lr(psr)
        return st._replace(alpha_f=self._mix(st.alpha_f, self._train(feat),
                                             lr),
                           model_x=self._mix(st.model_x, feat, lr))


# ---------------------------------------------------------------------------
# DSST
# ---------------------------------------------------------------------------

class DSSTState(NamedTuple):
    center: torch.Tensor
    base_sz: torch.Tensor
    scale: torch.Tensor
    num: torch.Tensor        # translation filter numerator (B, res, res, C)
    den: torch.Tensor
    snum: torch.Tensor       # (B, S, D) complex scale-filter numerator
    sden: torch.Tensor       # (B, S) real scale-filter denominator
    psr: torch.Tensor


class DSST(MOSSE):
    """Discriminative scale-space tracker: the multi-channel translation
    filter plus a 1-D correlation filter over a geometric scale pyramid
    (Danelljan et al., BMVC'14); the S scales of the B trackers are one
    (B, S) batch of windows."""

    name = "dsst"

    def __init__(self, prm: CFParams | None = None, device=None):
        super().__init__(prm, device)
        p, dev = self.prm, self.device
        ks = torch.arange(p.n_scales, dtype=torch.float32,
                          device=dev) - (p.n_scales - 1) / 2
        self.register_buffer("_scale_factors",
                             torch.pow(torch.tensor(p.scale_step,
                                                    dtype=torch.float32,
                                                    device=dev), ks),
                             persistent=False)
        self.register_buffer("_scale_win", 0.5 - 0.5 * torch.cos(
            2.0 * math.pi * (torch.arange(p.n_scales, dtype=torch.float32,
                                          device=dev) + 0.5) / p.n_scales),
            persistent=False)
        d = torch.remainder(torch.arange(p.n_scales, dtype=torch.float32,
                                         device=dev) + p.n_scales / 2.0,
                            p.n_scales) - p.n_scales / 2.0
        self.register_buffer("_Gs", torch.fft.fft(
            torch.exp(-0.5 * d ** 2 / p.scale_sigma ** 2)), persistent=False)

    # -- scale features -------------------------------------------------------
    def _scale_feats(self, frame, center, base_sz, scale) -> torch.Tensor:
        """(B, S, D) features: one flattened feature patch per scale (hog
        cells when features='hog', as the reference DSST)."""
        p = self.prm
        S = p.n_scales
        sizes = (base_sz * scale[:, None])[:, None, :] \
            * self._scale_factors[None, :, None]               # (B, S, 2)
        centers = center[:, None, :].expand(-1, S, -1)
        if p.features == "hog":
            raw = _grab(frame, centers, sizes, p.scale_res * p.cell)
            f = hog(raw, p.n_orient, p.cell).flatten(2)
        else:
            patch = _grab(frame, centers, sizes, p.scale_res)
            f = (patch - patch.mean(dim=(-2, -1), keepdim=True)).flatten(2)
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-6)
        return f * self._scale_win[None, :, None]

    def _scale_train(self, feats: torch.Tensor):
        Ff = torch.fft.fft(feats, dim=1)                   # (B, S, D)
        num = self._Gs[None, :, None] * torch.conj(Ff)
        den = torch.sum(torch.real(Ff * torch.conj(Ff)), dim=2)
        return num, den

    def _initialize(self, frame, corners_img) -> DSSTState:
        center, sz = _center_size_of(corners_img)
        b = center.shape[0]
        st = DSSTState(center=center, base_sz=sz,
                       scale=torch.ones((b,), device=self.device),
                       num=None, den=None, snum=None, sden=None,
                       psr=torch.full((b,), math.inf, device=self.device))
        num, den = self._train_terms(self._feat(frame, center,
                                                self._window_sz(st)))
        snum, sden = self._scale_train(
            self._scale_feats(frame, center, sz, st.scale))
        return st._replace(num=num, den=den, snum=snum, sden=sden)

    def _update(self, st: DSSTState, frame) -> DSSTState:
        p = self.prm
        S = p.n_scales
        # 1. translation (multi-channel filter at the current scale)
        center, psr = self._locate(st, frame)

        # 2. scale: the 1-D filter's response over the pyramid
        feats = self._scale_feats(frame, center, st.base_sz, st.scale)
        Zf = torch.fft.fft(feats, dim=1)
        resp = torch.real(torch.fft.ifft(
            torch.sum(st.snum * Zf, dim=2) / (st.sden + p.lam), dim=1))
        i = resp.argmax(dim=1)
        ar = torch.arange(resp.shape[0], device=resp.device)
        c = resp[ar, i]
        lo = resp[ar, (i - 1) % S]
        hi = resp[ar, (i + 1) % S]
        denom = 2.0 * c - lo - hi
        off = torch.where(denom.abs() > 1e-8,
                          0.5 * (hi - lo) / (denom + 1e-12),
                          torch.zeros_like(c))
        ds = _wrap_disp(i, S) + torch.clamp(off, -0.5, 0.5)
        scale = st.scale * torch.pow(torch.tensor(
            p.scale_step, dtype=torch.float32, device=ds.device), ds)
        scale = torch.clamp(scale, 1.0 / p.scale_max_ratio,
                            p.scale_max_ratio)
        st = st._replace(center=center, scale=scale, psr=psr)

        # 3. online update of both filters at the new state (PSR-gated)
        num, den = self._train_terms(self._feat(frame, center,
                                                self._window_sz(st)))
        snum, sden = self._scale_train(
            self._scale_feats(frame, center, st.base_sz, scale))
        lr = self._lr(psr)
        slr = (torch.where(lr > 0.0, p.scale_lr, 0.0)
               if isinstance(lr, torch.Tensor)
               else (p.scale_lr if lr > 0.0 else 0.0))
        return st._replace(num=self._mix(st.num, num, lr),
                           den=self._mix(st.den, den, lr),
                           snum=self._mix(st.snum, snum, slr),
                           sden=self._mix(st.sden, sden, slr))


CF_REGISTRY = {"mosse": MOSSE, "kcf": KCF, "dsst": DSST}

# the reference DSST and KCF run fHOG features; MOSSE is gray by design
_DEFAULT_FEATURES = {"mosse": "gray", "kcf": "hog", "dsst": "hog"}


def get_cf_tracker(key: str, device=None, **cfg) -> MOSSE:
    """A CF tracker from its key and `CFParams` fields (others ignored, as
    in the JAX package); HOG features take the KCF paper's kernel
    bandwidth 0.5 unless `kernel_sigma` says otherwise."""
    key = key.lower()
    cfg.setdefault("features", _DEFAULT_FEATURES.get(key, "gray"))
    if cfg["features"] == "hog":
        cfg.setdefault("kernel_sigma", 0.5)
    fields = set(CFParams.__dataclass_fields__)
    prm = CFParams(**{k: v for k, v in cfg.items() if k in fields})
    return CF_REGISTRY[key](prm, device=device)
