"""Learning/detection trackers (port of `mtf_tpu/sm/learn.py`) over a
leading batch of B trackers: RCT, MIL, Boosting, Struck, FragTrack and
DFT.

- RCT (Zhang et al., ECCV'12, compressive tracking): sparse random
  projections of rectangle sums over a shift grid and an online Gaussian
  naive-Bayes classifier. The measurement matrix is drawn at construction
  from `np.random.default_rng(seed)`, as in the JAX package, so one seed
  gives both packages the same rectangles; each rectangle sum at every
  shift is four gathers of one integral image (`ops/scan.py`, the JAX
  package's summation order).
- MIL (Babenko et al., CVPR'09) and Boosting (Grabner et al., BMVC'06):
  RCT's Haar pool re-boosted every update (greedy noisy-OR bag likelihood,
  or importance-weighted AdaBoost), `n_sel` rounds over (B, shifts, pool).
- Struck (Hare et al., ICCV'11): a budgeted structured-output SVM; per
  update `n_new` hard-negative SMO steps and `n_opt` re-balancing passes
  (the JAX `lax.scan`) over a fixed support buffer. Nothing is drawn: the
  JAX state's PRNG key is carried and never split, so the port keeps an
  update counter `step` in its place.
- FragTrack (Adam et al., CVPR'06): fragment histograms from an integral
  histogram, the robust 25% quantile of the fragments' L1 distances.
- DFT (Crivellaro & Lepetit, CVPR'14): any registration SM on the
  4-channel descriptor fields of the frame (`utils/preproc.py`).

The box trackers' frame reads are window samples (`sm/cf._grab`), so they
take per-tracker frames in `update_multi`; DFT transforms the per-tracker
frames in one batched pass (`utils/preproc.descriptor_fields`) and runs
its registration SM's `update_multi` on the fields.
Ties are broken as in the JAX package: `argmax` / `argmin` take the first
index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from mtf_tpu_torch.ops.scan import cumsum2
from mtf_tpu_torch.sm.cf import BoxTracker, _center_size_of, _corners_of, \
    _grab
from mtf_tpu_torch.sm.core import multi_frames


def _shift_grid(r: int, device) -> torch.Tensor:
    """(S, 2) xy shifts of a (2r + 1)^2 grid, row-major in (dy, dx)."""
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def _rect_index(rects, span: int, n_sh: int):
    """Flat integral-image indices (4, R, S) of each rectangle's four
    corners (y + h, x + w), (y + h, x), (y, x + w), (y, x) at every shift
    of an n_sh x n_sh grid, on an integral image of side span + 1; and
    the areas (R,)."""
    s = np.arange(n_sh)
    sy, sx = np.meshgrid(s, s, indexing="ij")
    sy, sx = sy.reshape(-1), sx.reshape(-1)
    w1 = span + 1
    idx = np.empty((4, len(rects), n_sh * n_sh), np.int64)
    for i, (y, x, h, w) in enumerate(rects):
        idx[0, i] = (y + h + sy) * w1 + x + w + sx
        idx[1, i] = (y + h + sy) * w1 + x + sx
        idx[2, i] = (y + sy) * w1 + x + w + sx
        idx[3, i] = (y + sy) * w1 + x + sx
    area = np.asarray([float(h * w) for (_, _, h, w) in rects], np.float32)
    return idx, area


def _rect_sums(ii: torch.Tensor, idx: torch.Tensor,
               area: torch.Tensor) -> torch.Tensor:
    """Rectangle means (B, S, R) from integral images ii (B, span + 1,
    span + 1) at the static corners `idx` (4, R, S) (`_rect_index`)."""
    flat = ii.flatten(1)
    g = [flat[:, idx[k]] for k in range(4)]           # (B, R, S) each
    s = (g[0] - g[1] - g[2] + g[3]) / area[None, :, None]
    return s.transpose(1, 2)


def _gauss_stats(feats: torch.Tensor, mask: torch.Tensor):
    """Masked mean and std (B, K) of features (B, S, K) over a static
    (S,) sample mask."""
    w = mask.to(feats.dtype)[None, :, None]
    n = torch.clamp(w.sum(), min=1.0)
    mu = (feats * w).sum(dim=1) / n
    var = ((feats - mu[:, None, :]) ** 2 * w).sum(dim=1) / n
    return mu, torch.sqrt(var + 1e-6)


def _logn(f, mu, s):
    v = torch.clamp(s, min=1e-2) ** 2
    return -0.5 * (f - mu) ** 2 / v - 0.5 * torch.log(v)


# ---------------------------------------------------------------------------
# RCT
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RCTParams:
    """ThirdParty/RCT `CompressiveTracker` analog (RCT.h:20-46)."""
    res: int = 48            # resampled bbox resolution (feature frame)
    search: int = 12         # detection shift radius (feature-frame px)
    n_feats: int = 50        # compressed dimensionality (featureNum)
    max_rects: int = 4       # rects per feature (featureMinNumRect..Max)
    pos_radius: int = 3      # positive-sample shift radius (rOuterPositive)
    neg_lo: int = 6          # negative annulus (search/2 .. search style)
    lr: float = 0.85         # Gaussian update rate (learnRate)
    seed: int = 0


class RCTState(NamedTuple):
    center: torch.Tensor    # (B, 2) xy image coords
    base_sz: torch.Tensor   # (B, 2) bbox w, h
    mu_pos: torch.Tensor    # (B, K)
    sg_pos: torch.Tensor    # (B, K)
    mu_neg: torch.Tensor    # (B, K)
    sg_neg: torch.Tensor    # (B, K)


class RCT(BoxTracker):
    """Compressive tracking: a random sparse measurement matrix and an
    online naive Bayes classifier (RCT eqs. 4-6)."""

    name = "rct"

    def __init__(self, prm: RCTParams | None = None, device=None):
        super().__init__(device)
        self.prm = prm or RCTParams()
        p, dev = self.prm, self.device
        rng = np.random.default_rng(p.seed)
        # each compressed feature is a +-1 weighted sum of 2..max_rects
        # rectangle means (RCT §3.1), drawn as the JAX package draws them
        rects, weights, owners = [], [], []
        for k in range(p.n_feats):
            n_r = int(rng.integers(2, p.max_rects + 1))
            for _ in range(n_r):
                w = int(rng.integers(2, p.res - 2))
                h = int(rng.integers(2, p.res - 2))
                x = int(rng.integers(0, p.res - w))
                y = int(rng.integers(0, p.res - h))
                rects.append((y, x, h, w))
                weights.append(float(rng.choice([-1.0, 1.0]) /
                                     np.sqrt(n_r)))
                owners.append(k)
        self._rects = rects
        proj = np.zeros((len(rects), p.n_feats), np.float32)
        proj[np.arange(len(rects)), np.asarray(owners)] = \
            np.asarray(weights, np.float32)
        idx, area = _rect_index(rects, p.res + 2 * p.search,
                                2 * p.search + 1)
        self.register_buffer("_proj", torch.tensor(proj, device=dev),
                             persistent=False)
        self.register_buffer("_idx", torch.tensor(idx, device=dev),
                             persistent=False)
        self.register_buffer("_area", torch.tensor(area, device=dev),
                             persistent=False)
        self.register_buffer("_shifts", _shift_grid(p.search, dev),
                             persistent=False)
        g = np.arange(-p.search, p.search + 1)
        dy, dx = np.meshgrid(g, g, indexing="ij")
        rad = np.sqrt(dy ** 2 + dx ** 2).ravel()
        self.register_buffer("_pos_mask", torch.tensor(
            rad <= p.pos_radius, device=dev), persistent=False)
        self.register_buffer("_neg_mask", torch.tensor(
            rad >= p.neg_lo, device=dev), persistent=False)

    # -- features -------------------------------------------------------------
    def _shift_feats(self, frame, center, sz) -> torch.Tensor:
        """(B, S, K) compressed features at every candidate shift: one
        window resample covering the box and the search margin, one
        integral image, the rectangle means at every shift, then the
        static (R, K) signed projection."""
        p = self.prm
        span = p.res + 2 * p.search
        win = _grab(frame, center, sz * (span / p.res), span)
        ii = torch.nn.functional.pad(cumsum2(win), (1, 0, 1, 0))
        return _rect_sums(ii, self._idx, self._area) @ self._proj

    # -- classifier -----------------------------------------------------------
    @staticmethod
    def _log_ratio(f, mu1, s1, mu0, s0):
        """sum_k log N(f|mu1,s1) - log N(f|mu0,s0) (RCT eq. 4): (B, S)."""
        return torch.sum(_logn(f, mu1[:, None], s1[:, None])
                         - _logn(f, mu0[:, None], s0[:, None]), dim=-1)

    def _seed_stats(self, feats):
        return (_gauss_stats(feats, self._pos_mask),
                _gauss_stats(feats, self._neg_mask))

    def _learn(self, st, feats):
        """Online Gaussian update (RCT eq. 6; the sigma mix in the
        variance domain, RCT.cpp:classifierUpdate) from the shift-grid
        samples around the (already updated) centers."""
        lr = self.prm.lr
        (mu_p, sg_p), (mu_n, sg_n) = self._seed_stats(feats)

        def mix(old, new):
            return lr * old + (1.0 - lr) * new

        def vmix(so, sn, mo, mn):
            return torch.sqrt(lr * so ** 2 + (1 - lr) * sn ** 2
                              + lr * (1 - lr) * (mo - mn) ** 2)

        return st._replace(
            mu_pos=mix(st.mu_pos, mu_p),
            sg_pos=vmix(st.sg_pos, sg_p, st.mu_pos, mu_p),
            mu_neg=mix(st.mu_neg, mu_n),
            sg_neg=vmix(st.sg_neg, sg_n, st.mu_neg, mu_n))

    def _step(self, st, feats) -> torch.Tensor:
        """The new centers (B, 2) from the best-scoring shift."""
        best = self._scores(st, feats).argmax(dim=1)
        return st.center + self._shifts[best] * (st.base_sz / self.prm.res)

    def _scores(self, st, feats):
        return self._log_ratio(feats, st.mu_pos, st.sg_pos, st.mu_neg,
                               st.sg_neg)

    # -- protocol ---------------------------------------------------------------
    def _initialize(self, frame, corners_img) -> RCTState:
        center, sz = _center_size_of(corners_img)
        (mu_p, sg_p), (mu_n, sg_n) = self._seed_stats(
            self._shift_feats(frame, center, sz))
        return RCTState(center=center, base_sz=sz, mu_pos=mu_p, sg_pos=sg_p,
                        mu_neg=mu_n, sg_neg=sg_n)

    def _update(self, st: RCTState, frame) -> RCTState:
        center = self._step(st, self._shift_feats(frame, st.center,
                                                  st.base_sz))
        st = st._replace(center=center)
        # re-extract around the new centers for learning (RCT alg. 1)
        return self._learn(st, self._shift_feats(frame, center, st.base_sz))

    def corners(self, st) -> torch.Tensor:
        return _corners_of(st.center, st.base_sz).transpose(-1, -2)

    def set_region(self, st, corners_img, frame=None):
        center, sz = _center_size_of(self._corners_in(corners_img))
        return st._replace(center=center, base_sz=sz)


# ---------------------------------------------------------------------------
# MIL and Boosting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MILParams(RCTParams):
    """ThirdParty/MIL analog (MILTrack's Haar pool, lRate 0.85)."""
    n_feats: int = 150       # Haar feature pool (numFeat)
    n_sel: int = 40          # weak classifiers selected per frame (numSel)


class MILState(NamedTuple):
    center: torch.Tensor
    base_sz: torch.Tensor
    mu_pos: torch.Tensor    # (B, M)
    sg_pos: torch.Tensor
    mu_neg: torch.Tensor
    sg_neg: torch.Tensor
    sel: torch.Tensor       # (B, K) int64 selected pool indices


class MIL(RCT):
    """Online multiple-instance-learning boosting (ThirdParty/MIL,
    `cf/OnlineMILBoost`): RCT's Haar pool with per-feature online
    Gaussians, re-boosted every update by greedy noisy-OR bag-likelihood
    selection; detection scores every shift with the selected ensemble."""

    name = "mil"

    def __init__(self, prm: MILParams | None = None, device=None):
        super().__init__(prm or MILParams(), device)

    def _weak_h(self, st, feats) -> torch.Tensor:
        """Weak log-odds of every pool feature at every sample (B, S, M)."""
        return (_logn(feats, st.mu_pos[:, None], st.sg_pos[:, None])
                - _logn(feats, st.mu_neg[:, None], st.sg_neg[:, None]))

    def _boost_select(self, h: torch.Tensor) -> torch.Tensor:
        """Greedy MILBoost (noisy-OR bag likelihood, Babenko eq. 7): round k
        adds the pool feature maximizing log(1 - prod_pos(1 - sigmoid(H +
        h_m))) + sum_neg log(1 - sigmoid(H + h_m)). (B, K) indices."""
        b, _, m = h.shape
        posf = self._pos_mask.to(h.dtype)[None, :, None]
        negf = self._neg_mask.to(h.dtype)[None, :, None]
        H = torch.zeros(h.shape[:2], dtype=h.dtype, device=h.device)
        taken = torch.zeros((b, m), dtype=torch.bool, device=h.device)
        sel = []
        for _ in range(self.prm.n_sel):
            cand = torch.sigmoid(H[:, :, None] + h)
            log1m = torch.log1p(-torch.clamp(cand, 1e-6, 1 - 1e-6))
            bag_log = torch.log1p(-torch.exp(torch.sum(log1m * posf, dim=1))
                                  + 1e-12)
            lik = bag_log + torch.sum(log1m * negf, dim=1)
            lik = torch.where(taken, -torch.inf, lik)
            k = lik.argmax(dim=1)
            sel.append(k)
            taken = taken.clone()
            taken[torch.arange(b, device=h.device), k] = True
            H = H + torch.gather(h, 2, k[:, None, None].expand(
                -1, h.shape[1], 1))[..., 0]
        return torch.stack(sel, dim=1)

    def _scores(self, st, feats):
        h = self._weak_h(st, feats)
        return torch.gather(h, 2, st.sel[:, None, :].expand(
            -1, h.shape[1], -1)).sum(dim=-1)

    def _initialize(self, frame, corners_img) -> MILState:
        center, sz = _center_size_of(corners_img)
        feats = self._shift_feats(frame, center, sz)
        (mu_p, sg_p), (mu_n, sg_n) = self._seed_stats(feats)
        st = MILState(center=center, base_sz=sz, mu_pos=mu_p, sg_pos=sg_p,
                      mu_neg=mu_n, sg_neg=sg_n, sel=None)
        return st._replace(sel=self._boost_select(self._weak_h(st, feats)))

    def _update(self, st: MILState, frame) -> MILState:
        center = self._step(st, self._shift_feats(frame, st.center,
                                                  st.base_sz))
        st = st._replace(center=center)
        # learning at the new centers: Gaussian pool update + re-boost
        feats2 = self._shift_feats(frame, center, st.base_sz)
        st = self._learn(st, feats2)
        return st._replace(sel=self._boost_select(self._weak_h(st, feats2)))


@dataclass(frozen=True)
class BoostParams(RCTParams):
    """ThirdParty/Boosting `StrongClassifierDirectSelection` analog."""
    n_feats: int = 150
    n_sel: int = 40


class BoostState(NamedTuple):
    center: torch.Tensor
    base_sz: torch.Tensor
    mu_pos: torch.Tensor
    sg_pos: torch.Tensor
    mu_neg: torch.Tensor
    sg_neg: torch.Tensor
    sel: torch.Tensor       # (B, K) int64 selector choices
    alpha: torch.Tensor     # (B, K) selector vote weights


class Boosting(MIL):
    """Online AdaBoost (ThirdParty/Boosting): the same Haar pool and online
    Gaussians, each selector round picking the stump of least weighted
    error, voting alpha = .5 log((1 - e) / e) and re-weighting the
    samples (`StrongClassifierDirectSelection::update`)."""

    name = "boost"

    def __init__(self, prm: BoostParams | None = None, device=None):
        RCT.__init__(self, prm or BoostParams(), device)

    def _ada_select(self, h: torch.Tensor):
        """(B, K) indices and (B, K) alphas by importance-weighted AdaBoost
        over the stump predictions sign(h)."""
        b, _, m = h.shape
        pos = self._pos_mask
        y = torch.where(pos, 1.0, -1.0).to(h.dtype)            # (S,)
        in_set = (pos | self._neg_mask).to(h.dtype)
        lam = (in_set / torch.clamp(in_set.sum(), min=1.0))[None].expand(
            b, -1)
        pred = torch.sign(h)                                   # (B, S, M)
        wrong = (pred * y[None, :, None] < 0).to(h.dtype)
        taken = torch.zeros((b, m), dtype=torch.bool, device=h.device)
        ar = torch.arange(b, device=h.device)
        sel, alpha = [], []
        for _ in range(self.prm.n_sel):
            err = torch.sum(lam[:, :, None] * wrong, dim=1) \
                / torch.clamp(lam.sum(dim=1, keepdim=True), min=1e-8)
            err = torch.where(taken, torch.inf,
                              torch.clamp(err, 1e-4, 1 - 1e-4))
            k = err.argmin(dim=1)
            e = err[ar, k]
            a = 0.5 * torch.log((1.0 - e) / e)
            sel.append(k)
            alpha.append(a)
            taken = taken.clone()
            taken[ar, k] = True
            lam = lam * torch.exp(-a[:, None] * y[None] * pred[ar, :, k]) \
                * in_set[None]
            lam = lam / torch.clamp(lam.sum(dim=1, keepdim=True), min=1e-8)
        return torch.stack(sel, dim=1), torch.stack(alpha, dim=1)

    def _scores(self, st, feats):
        # soft stump votes weighted by alpha (the JAX package's choice)
        h = self._weak_h(st, feats)
        hs = torch.gather(h, 2, st.sel[:, None, :].expand(-1, h.shape[1],
                                                          -1))
        return torch.sum(torch.tanh(hs) * st.alpha[:, None, :], dim=-1)

    def _initialize(self, frame, corners_img) -> BoostState:
        center, sz = _center_size_of(corners_img)
        feats = self._shift_feats(frame, center, sz)
        (mu_p, sg_p), (mu_n, sg_n) = self._seed_stats(feats)
        st = BoostState(center=center, base_sz=sz, mu_pos=mu_p,
                        sg_pos=sg_p, mu_neg=mu_n, sg_neg=sg_n, sel=None,
                        alpha=None)
        sel, alpha = self._ada_select(self._weak_h(st, feats))
        return st._replace(sel=sel, alpha=alpha)

    def _update(self, st: BoostState, frame) -> BoostState:
        center = self._step(st, self._shift_feats(frame, st.center,
                                                  st.base_sz))
        st = st._replace(center=center)
        feats2 = self._shift_feats(frame, center, st.base_sz)
        st = self._learn(st, feats2)
        sel, alpha = self._ada_select(self._weak_h(st, feats2))
        return st._replace(sel=sel, alpha=alpha)


# ---------------------------------------------------------------------------
# Struck
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StruckParams:
    """ThirdParty/Struck `Config` analog (raw features, Gaussian kernel)."""
    res: int = 16            # raw-feature patch resolution (16x16 = 256-d)
    search: int = 8          # shift radius in feature-frame px
    budget: int = 64         # support-vector budget (svmBudgetSize)
    C: float = 100.0         # SVM slack (svmC)
    kernel_sigma: float = 1.0  # Gaussian kernel bandwidth (unit-norm feats)
    n_new: int = 3           # hard-negative ProcessNew rounds per frame
    n_opt: int = 4           # Optimize reprocess passes per frame
    seed: int = 0


class StruckState(NamedTuple):
    center: torch.Tensor    # (B, 2) xy
    base_sz: torch.Tensor   # (B, 2)
    sv_x: torch.Tensor      # (B, budget, D) support-vector features
    sv_beta: torch.Tensor   # (B, budget) dual coefficients
    sv_pos: torch.Tensor    # (B, budget) 1 where the SV entered positive
    sv_valid: torch.Tensor  # (B, budget) slot occupancy
    step: torch.Tensor      # () int64 update count (the JAX state's key)


class Struck(BoxTracker):
    """Structured-output SVM tracking with budget maintenance (Hare et al.,
    ICCV'11), LaRank reduced as in the JAX package: per update `n_new`
    ProcessNew SMO steps on the (true location, hardest negative) pair and
    `n_opt` Optimize passes over the support set; eviction overwrites the
    smallest-|beta| slot; the structured loss is 1 - IoU of the shifted
    boxes."""

    name = "strk"

    def __init__(self, prm: StruckParams | None = None, device=None):
        super().__init__(device)
        self.prm = prm or StruckParams()
        p = self.prm
        self.register_buffer("_shifts", _shift_grid(p.search, self.device),
                             persistent=False)
        ov = torch.clamp(p.res - self._shifts.abs(), min=0.0)     # (S, 2)
        inter = ov[:, 0] * ov[:, 1]
        self.register_buffer("_loss", 1.0 - inter / (
            2.0 * p.res * p.res - inter), persistent=False)
        self._ipos = int(self._loss.argmin())                     # no shift

    def _cand_feats(self, frame, center, sz) -> torch.Tensor:
        """(B, S, D) unit-norm raw features of every candidate shift."""
        p = self.prm
        span = p.res + 2 * p.search
        win = _grab(frame, center, sz * (span / p.res), span)
        f = win.unfold(1, p.res, 1).unfold(2, p.res, 1).reshape(
            win.shape[0], -1, p.res * p.res)
        f = f - f.mean(dim=-1, keepdim=True)
        return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-6)

    def _kernel(self, a, b):
        """Gaussian kernel matrices exp(-sigma ||a - b||^2), (B, n, m)."""
        d2 = ((a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :]
              - 2.0 * a @ b.transpose(1, 2))
        return torch.exp(-self.prm.kernel_sigma * torch.clamp(d2, min=0.0))

    def _F(self, st, x):
        """Discriminant F(x) = sum_i beta_i k(x_i, x) for x (B, S, D)."""
        k = self._kernel(st.sv_x, x)                                # (B, n, S)
        return ((st.sv_beta * st.sv_valid)[:, None, :] @ k)[:, 0]

    def _add_sv(self, st, x, dbeta, is_pos: float):
        """Write an SV into each tracker's smallest-|beta| (or free) slot;
        returns (state, slots) so that further beta can accumulate onto
        the same slot (LaRank semantics)."""
        score = torch.where(st.sv_valid > 0.5, st.sv_beta.abs(),
                            torch.full_like(st.sv_beta, -1.0))
        slot = score.argmin(dim=1)
        ar = torch.arange(slot.shape[0], device=slot.device)
        sv_x, beta = st.sv_x.clone(), st.sv_beta.clone()
        pos, valid = st.sv_pos.clone(), st.sv_valid.clone()
        sv_x[ar, slot] = x
        beta[ar, slot] = dbeta
        pos[ar, slot] = is_pos
        valid[ar, slot] = 1.0
        return st._replace(sv_x=sv_x, sv_beta=beta, sv_pos=pos,
                           sv_valid=valid), slot

    def _learn(self, st: StruckState, frame) -> StruckState:
        """ProcessNew at the current centers, then the Optimize passes."""
        p = self.prm
        feats = self._cand_feats(frame, st.center, st.base_sz)
        ar = torch.arange(feats.shape[0], device=feats.device)
        xp = feats[:, self._ipos]
        pos_slot = None
        for _ in range(p.n_new):
            g = -self._loss - self._F(st, feats)                    # (B, S)
            ineg = g.argmin(dim=1)
            xn = feats[ar, ineg]
            kpn = self._kernel(xp[:, None], xn[:, None])[:, 0, 0]
            denom = torch.clamp(2.0 - 2.0 * kpn, min=1e-8)
            lam = torch.clamp((g[:, self._ipos] - g[ar, ineg]) / denom,
                              0.0, p.C)
            if pos_slot is None:
                st, pos_slot = self._add_sv(st, xp, lam, 1.0)
            else:
                beta = st.sv_beta.clone()
                beta[ar, pos_slot] += lam
                st = st._replace(sv_beta=beta)
            st, _ = self._add_sv(st, xn, -lam, 0.0)

        # Optimize: re-balance an existing pos/neg SV pair (LaRank)
        for _ in range(p.n_opt):
            kmat = self._kernel(st.sv_x, st.sv_x)
            Fsv = ((st.sv_beta * st.sv_valid)[:, None, :] @ kmat)[:, 0]
            gsv = -(1.0 - st.sv_pos) - Fsv
            vp = st.sv_valid * st.sv_pos
            vn = st.sv_valid * (1.0 - st.sv_pos)
            ip = torch.where(vp > 0.5, gsv, -1e30).argmax(dim=1)
            im = torch.where(vn > 0.5, gsv, 1e30).argmin(dim=1)
            kpn = kmat[ar, ip, im]
            denom = torch.clamp(kmat[ar, ip, ip] + kmat[ar, im, im]
                                - 2 * kpn, min=1e-8)
            lam = (gsv[ar, ip] - gsv[ar, im]) / denom
            lam = torch.minimum(torch.maximum(lam, -st.sv_beta[ar, im].abs()),
                                torch.full_like(lam, p.C))
            beta = st.sv_beta.clone()
            beta[ar, ip] += lam
            beta[ar, im] += -lam
            st = st._replace(sv_beta=beta)
        return st

    def _initialize(self, frame, corners_img) -> StruckState:
        p = self.prm
        center, sz = _center_size_of(corners_img)
        b, dev = center.shape[0], self.device
        D = p.res * p.res
        st = StruckState(center=center, base_sz=sz,
                         sv_x=torch.zeros((b, p.budget, D), device=dev),
                         sv_beta=torch.zeros((b, p.budget), device=dev),
                         sv_pos=torch.zeros((b, p.budget), device=dev),
                         sv_valid=torch.zeros((b, p.budget), device=dev),
                         step=torch.zeros((), dtype=torch.int64))
        return self._learn(st, frame)

    def _update(self, st: StruckState, frame) -> StruckState:
        feats = self._cand_feats(frame, st.center, st.base_sz)
        best = self._F(st, feats).argmax(dim=1)
        center = st.center + self._shifts[best] * (st.base_sz / self.prm.res)
        st = self._learn(st._replace(center=center), frame)
        return st._replace(step=st.step + 1)

    def corners(self, st) -> torch.Tensor:
        return _corners_of(st.center, st.base_sz).transpose(-1, -2)

    def set_region(self, st, corners_img, frame=None):
        center, sz = _center_size_of(self._corners_in(corners_img))
        return st._replace(center=center, base_sz=sz)


# ---------------------------------------------------------------------------
# FragTrack
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FragParams:
    """ThirdParty/FRG `Fragments_Tracker` analog (Adam et al., CVPR'06)."""
    res: int = 40            # template resolution (feature frame)
    search: int = 10         # shift radius (feature-frame px)
    n_bins: int = 16         # grayscale histogram bins
    frag_grid: int = 4       # frag_grid^2 template fragments
    quantile: float = 0.25   # robust vote: this quantile of the fragments'
                             # distances scores a candidate


class FragState(NamedTuple):
    center: torch.Tensor       # (B, 2) xy
    base_sz: torch.Tensor      # (B, 2)
    templ_hists: torch.Tensor  # (B, F, n_bins) fragment template histograms


class FragTrack(BoxTracker):
    """Fragments-based tracking with integral histograms: every candidate
    shift scores every template fragment by the L1 distance of
    area-normalized gray histograms, and the `quantile` of the fragment
    distances (a minority of occluded fragments cannot veto) picks the
    shift."""

    name = "frg"

    def __init__(self, prm: FragParams | None = None, device=None):
        super().__init__(device)
        self.prm = prm or FragParams()
        p = self.prm
        f = p.res // p.frag_grid
        self._rects = [(iy * f, ix * f, f, f) for iy in range(p.frag_grid)
                       for ix in range(p.frag_grid)]
        self.register_buffer("_shifts", _shift_grid(p.search, self.device),
                             persistent=False)
        self.register_buffer("_edges", torch.linspace(
            0.0, 255.0, p.n_bins + 1, device=self.device)[1:-1].contiguous(),
            persistent=False)

    def _bin_planes(self, win):
        """(B, H + 1, W + 1, n_bins) integral histograms of gray patches."""
        idx = torch.searchsorted(self._edges, win.contiguous())
        planes = torch.nn.functional.one_hot(idx, self.prm.n_bins).to(
            win.dtype)
        ii = cumsum2(planes, dims=(1, 2))
        return torch.nn.functional.pad(ii, (0, 0, 1, 0, 1, 0))

    def _frag_hists(self, ii, n_sh):
        """(B, F, n_sh·n_sh, n_bins) area-normalized fragment histograms at
        every candidate shift."""
        hists = []
        for (y, x, h, w) in self._rects:
            s = (ii[:, y + h:y + h + n_sh, x + w:x + w + n_sh]
                 - ii[:, y + h:y + h + n_sh, x:x + n_sh]
                 - ii[:, y:y + n_sh, x + w:x + w + n_sh]
                 + ii[:, y:y + n_sh, x:x + n_sh]) / float(h * w)
            hists.append(s.reshape(ii.shape[0], -1, self.prm.n_bins))
        return torch.stack(hists, dim=1)

    def _quantile(self, d):
        """`jnp.quantile(d, q, axis=1)`'s linear rule on (B, F, S): the
        sorted fragment distances at floor and ceil of q (F - 1), weighted
        as the JAX package weighs them."""
        n = d.shape[1]
        q = torch.tensor(self.prm.quantile, dtype=torch.float32) * (n - 1)
        lo = torch.floor(q)
        hw = q - lo
        lw = 1.0 - hw
        lo_i = int(torch.clamp(lo, 0, n - 1))
        hi_i = int(torch.clamp(torch.ceil(q), 0, n - 1))
        s = torch.sort(d, dim=1).values
        return s[:, lo_i] * lw.to(d.device) + s[:, hi_i] * hw.to(d.device)

    def _initialize(self, frame, corners_img) -> FragState:
        center, sz = _center_size_of(corners_img)
        ii = self._bin_planes(_grab(frame, center, sz, self.prm.res))
        return FragState(center=center, base_sz=sz,
                         templ_hists=self._frag_hists(ii, 1)[:, :, 0, :])

    def _update(self, st: FragState, frame) -> FragState:
        p = self.prm
        span = p.res + 2 * p.search
        win = _grab(frame, st.center, st.base_sz * (span / p.res), span)
        hists = self._frag_hists(self._bin_planes(win), 2 * p.search + 1)
        d = torch.sum(torch.abs(hists - st.templ_hists[:, :, None, :]),
                      dim=-1)                                   # (B, F, S)
        best = self._quantile(d).argmin(dim=1)
        return st._replace(center=st.center + self._shifts[best]
                           * (st.base_sz / p.res))

    def corners(self, st) -> torch.Tensor:
        return _corners_of(st.center, st.base_sz).transpose(-1, -2)

    def set_region(self, st, corners_img, frame=None):
        center, sz = _center_size_of(self._corners_in(corners_img))
        return st._replace(center=center, base_sz=sz)


# ---------------------------------------------------------------------------
# DFT
# ---------------------------------------------------------------------------

class DFT(nn.Module):
    """Descriptor-Fields tracking: the registration SM `inner` run on the
    4-channel smoothed positive/negative-gradient transform of each frame
    (`utils/preproc.descriptor_fields`)."""

    name = "dft"

    def __init__(self, inner, sigma: float = 1.5):
        super().__init__()
        self.inner = inner
        self.ssm = inner.ssm
        self.am = inner.am
        self.prm = inner.prm
        self.sigma = float(sigma)

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def _tf(self, frame):
        from mtf_tpu_torch.utils.preproc import descriptor_fields
        return descriptor_fields(torch.as_tensor(
            frame, dtype=torch.float32, device=self.device), self.sigma)

    def initialize(self, frame, corners_img):
        return self.inner.initialize(self._tf(frame), corners_img)

    def update(self, state, frame):
        return self.inner.update(state, self._tf(frame))

    def update_multi(self, state, frames):
        """Each tracker on its own frame of (B, H, W[, C]): the fields of
        the stack in one batched pass, then the inner SM's
        `update_multi`."""
        from mtf_tpu_torch.utils.preproc import descriptor_fields
        fields = descriptor_fields(multi_frames(frames, self.device),
                                   self.sigma, batched=True)
        return self.inner.update_multi(state, fields)

    def corners(self, state):
        return self.inner.corners(state)

    def set_region(self, state, corners_img, frame=None):
        return self.inner.set_region(state, corners_img)

    def reinitialize(self, frame, corners_img):
        return self.initialize(frame, corners_img)


LEARN_REGISTRY = {"rct": RCT, "strk": Struck, "struck": Struck,
                  "frg": FragTrack, "frag": FragTrack,
                  "mil": MIL, "boost": Boosting, "bsr": Boosting}
LEARN_PARAMS = {RCT: RCTParams, Struck: StruckParams, FragTrack: FragParams,
                MIL: MILParams, Boosting: BoostParams}


def get_learn_tracker(key: str, device=None, **cfg):
    """A learn tracker from its key and its parameter class's fields
    (others ignored, as in the JAX package)."""
    cls = LEARN_REGISTRY[key.lower()]
    prm_cls = LEARN_PARAMS[cls]
    fields = set(prm_cls.__dataclass_fields__)
    return cls(prm_cls(**{k: v for k, v in cfg.items() if k in fields}),
               device=device)
