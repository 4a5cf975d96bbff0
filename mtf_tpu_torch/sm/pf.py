"""Particle-filter search method (port of `mtf_tpu/sm/pf.py`), over B
trackers of P particles each.

One update: propagate every particle (random walk or AR(1), additive or
compositional), sample its patch and score it (the AM's likelihood, a
Gaussian or a reciprocal one), adaptively resample (systematic: a cumsum
and `searchsorted`), re-weight the sampler distributions, and take the
weighted, corner or best mean. With `score_stride > 1` the particles are
ranked on a stride-decimated point grid (optionally of the binomial-
blurred, downsampled frame) and the top `rescore_top_k` are re-scored at
full resolution; the rest get -1e30.

With a dense kind (`interp="<kind>_mm"`) on a gray frame every tracker's
particles sample one window of `crop` pixels anchored at the centre of
its particle cloud, and a particle with a point outside it is invalid
(`_apply_window_mask`), as in the JAX package; `interp_bf16` rounds the
window's values and the tap weights to bfloat16 there.

`update_multi` runs the same update on per-tracker frames (B, H, W, C):
each tracker's particles, scoring frame (blurred, downsampled) and
template learning read its own frame, and a gray stack (B, H, W, 1)
takes the dense window route, as each tracker of a `vmap`ped JAX fleet
sees an (H, W) frame. The draws are `update`'s.

Draws: each update's draws (`PFDraw`) are a function of (`seed`, update
count) alone, made on the tracker's device and shared by the B trackers,
as every tracker of a JAX fleet draws from the same key. They all come
from `_draw`, which a caller may override (the parity tests hand it the
JAX package's own draws).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from mtf_tpu_torch.am.base import AMState
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.sm.composite import where_state
from mtf_tpu_torch.sm.core import (SearchMethod, TrackerState, is_gray,
                                   sampler_sigma, seeded_generator)
from mtf_tpu_torch.sm.lk import _blur2, _blur_windows

_NEG = -1e30


@dataclass(frozen=True)
class PFParams:
    """Reference PFParams.h analog (the JAX package's fields and
    defaults)."""
    n_particles: int = 200
    dynamic_model: str = "rw"           # rw | ar1
    update_type: str = "compositional"  # compositional | additive
    likelihood: str = "am"              # am | gaussian | reciprocal
    resampling: str = "systematic"      # none | systematic
    mean_type: str = "weighted"         # weighted | corner | best
    pix_sigma: float = 3.0              # state sigma from pixels, unless
    ssm_sigma: tuple = ()               # explicit per-dof sigmas
    ssm_sigmas: tuple = ()              # several sampler distributions,
    adapt_distr: bool = True            # re-weighted by likelihood mass
    ar_alpha: float = 0.5
    n_eff_ratio: float = 0.5            # adaptive resampling threshold
    measurement_sigma: float = 0.1      # gaussian likelihood scale
    jacobian_as_sigma: bool = False     # sigma from one Gauss-Newton step
    am_sigma: tuple = ()                # photometric random walk (only
                                        # with an ILM that has parameters;
                                        # ignored otherwise)
    score_stride: int = 1               # > 1: rank on the decimated grid
    score_blur: bool = False            # ... of the binomial-blurred frame
    score_downsample: bool = False      # ... downsampled by the stride
    rescore_crop: int = 0               # the top-K rescore's own window
    rescore_top_k: int = 0              # full-resolution rescore of K
    seed: int = 0


class PFState(NamedTuple):
    """Per-tracker particle state (B leading); `step` takes the place of
    the JAX package's key."""
    particles: torch.Tensor       # (B, P, S)
    prev_particles: torch.Tensor  # (B, P, S) for AR(1)
    log_weights: torch.Tensor     # (B, P)
    step: torch.Tensor            # () int64 on the CPU: updates so far
    distr_log_w: torch.Tensor     # (B, D) sampler-distribution weights
    am_particles: torch.Tensor    # (B, P, P_am) photometric particles
    score_am: AMState | None = None  # decimated-grid AM state (stride > 1)


class PFDraw(NamedTuple):
    """One update's draws, shared by the trackers."""
    prop: torch.Tensor    # (P, S) standard normals of the proposals
    gumbel: torch.Tensor  # (P, D) Gumbel noise of the distribution index
    u0: torch.Tensor      # () uniform [0, 1) offset of the resampler
    am: torch.Tensor      # (P, P_am) standard normals of the AM walk


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, P, ...) at indices idx (B, K) along the particle axis."""
    i = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, i)


def _particle_view(st: AMState) -> AMState:
    """An AM state whose tensors carry a particle axis of 1 after B, so
    that the AM scores (B, P, N, C) patches against it."""
    def up(x):
        if isinstance(x, torch.Tensor):
            return x.unsqueeze(1)
        if isinstance(x, tuple):
            return type(x)(*map(up, x)) if hasattr(x, "_fields") \
                else tuple(map(up, x))
        return x
    return up(st)


def systematic_indices(log_w: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Systematic resampling of log-weights (B, P) at offset u0 (): the
    particle indices (B, P), `searchsorted` (left) of (i + u0) / P in the
    cumulative weights, clipped to [0, P - 1]."""
    P = log_w.shape[-1]
    cum = torch.cumsum(torch.exp(log_w), dim=-1)
    u = (torch.arange(P, dtype=log_w.dtype, device=log_w.device) + u0) / P
    idx = torch.searchsorted(cum, u.expand_as(cum).contiguous(), right=False)
    return idx.clamp(0, P - 1)


class PF(SearchMethod):
    name = "pf"
    SALT = 1

    def __init__(self, am, ssm, prm=None, pf: PFParams | None = None):
        super().__init__(am, ssm, prm)
        self.pf = pf or PFParams()
        s = self.pf.score_stride
        if self.pf.score_downsample and (s <= 1 or not self.pf.score_blur):
            raise ValueError(
                "PFParams.score_downsample requires score_stride > 1 and "
                "score_blur=True (the binomial blur is the anti-alias "
                "filter of the downsampled scoring pyramid level)")
        if s > 1:
            ry, rx = self.am.prm.resy, self.am.prm.resx
            r, c = np.arange(0, ry, s), np.arange(0, rx, s)
            self.register_buffer("score_idx", torch.as_tensor(
                (r[:, None] * rx + c[None, :]).ravel(), device=self.device))
            try:
                self._score_am = type(self.am)(
                    replace(self.am.prm, resx=len(c), resy=len(r)),
                    self.am.ilm)
            except TypeError as e:
                raise ValueError(
                    "PFParams.score_stride > 1 requires an AM "
                    "constructible as type(am)(params, ilm); "
                    f"{type(self.am).__name__} is not ({e})") from e
        else:
            self.score_idx = None
            self._score_am = self.am

    @property
    def _sample_am(self) -> bool:
        """The photometric random walk runs only with `am_sigma` and an ILM
        that has parameters (`mtf_tpu/sm/pf.py:296-298`)."""
        return bool(self.pf.am_sigma) and self.am.ilm.n_params > 0

    # -- helpers -------------------------------------------------------
    def _draw(self, step: int) -> PFDraw:
        """Update `step`'s draws (overridable: the parity tests hand in
        the JAX package's)."""
        P, S = self.pf.n_particles, self.ssm.dof
        D = max(1, len(self.pf.ssm_sigmas))
        gen = seeded_generator(self.pf.seed, step, self.SALT, self.device)
        kw = dict(generator=gen, device=self.device)
        prop = torch.randn((P, S), **kw)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.rand((P, D), **kw).clamp_min(
            tiny)))
        u0 = torch.rand((), **kw)
        am = torch.randn((P, self.am.ilm.n_params), **kw)
        return PFDraw(prop, gumbel, u0, am)

    def _sigma(self, region) -> torch.Tensor:
        """(B, S) sampler sigmas."""
        return sampler_sigma(self.ssm, region, self.pf.ssm_sigma,
                             self.pf.pix_sigma)

    def _particle_patches(self, region, states, frame, base_pts=None,
                          pts_scale=None, crop=None, extent=None):
        """(B, P, N, C) patches of particles (B, P, S) and their (B, P)
        validity. With a dense kind on a gray frame each tracker's
        particles sample one window of `crop` (None: `prm.crop`) anchored
        at the centre of its point cloud; a particle with a point outside
        it is invalid. `base_pts`: the template-frame points (default the
        region's grid); `pts_scale`: scales the image-frame points (the
        downsampled scoring pass); `extent`: maps the cloud's (4, B)
        (min x, -max x, min y, -max y) to the one the window is anchored
        on (`ShardedPF`: the whole population's, over every shard)."""
        if base_pts is None:
            base_pts = region.base_pts
        B, P = states.shape[:2]
        pts_t = self.ssm.warp_pts(states, base_pts[:, None])   # (B, P, N, 2)
        pts = W.apply_warp(region.norm_mat[:, None], pts_t).reshape(B, -1, 2)
        if pts_scale is not None:
            pts = pts * pts_scale
        prm = self.prm
        ok = torch.ones((B, P), dtype=torch.bool, device=states.device)
        if prm.interp.endswith(interp.MM_SUFFIX) and is_gray(frame):
            kind = prm.interp[:-len(interp.MM_SUFFIX)]
            h, w = frame.shape[-3:-1] if frame.dim() == 4 else frame.shape
            crop = prm.crop if crop is None else crop
            if crop is not None and (crop < h or crop < w):
                hc, wc = min(crop, h), min(crop, w)
                x, y = pts[..., 0], pts[..., 1]
                ext = torch.stack([x.amin(-1), -x.amax(-1), y.amin(-1),
                                   -y.amax(-1)])
                if extent is not None:
                    ext = extent(ext)
                cx = 0.5 * (ext[0] - ext[1])
                cy = 0.5 * (ext[2] - ext[3])
                x0 = torch.clamp(torch.nan_to_num(
                    torch.floor(cx - 0.5 * wc), nan=0.0), 0.0, float(w - wc))
                y0 = torch.clamp(torch.nan_to_num(
                    torch.floor(cy - 0.5 * hc), nan=0.0), 0.0, float(h - hc))
                x = x - x0[:, None]
                y = y - y0[:, None]
                in_w = ((x >= 0.0) & (x <= wc - 1.0)
                        & (y >= 0.0) & (y <= hc - 1.0))
                ok = in_w.reshape(B, P, -1).all(dim=-1)
                rows = y0.long()[:, None] + torch.arange(
                    hc, device=frame.device)
                cols = x0.long()[:, None] + torch.arange(
                    wc, device=frame.device)
                # (each tracker's own frame of per-tracker frames)
                base = (torch.arange(B, device=frame.device)[:, None, None]
                        * (h * w) if frame.dim() == 4 else 0)
                win = frame.reshape(-1)[base + rows[:, :, None] * w
                                        + cols[:, None, :]]  # (B, hc, wc)
                val = interp.sample_windows(win, x, y, kind=kind,
                                            bf16=prm.interp_bf16)[..., None]
            else:
                val, _ = interp.sample_dense(frame, pts, kind, crop=None,
                                             need_grad=False,
                                             bf16=prm.interp_bf16)
        else:
            val = interp.sample(frame, pts, prm.interp, prm.border)
        return val.reshape(B, P, -1, val.shape[-1]), ok

    def _score_frame(self, frame):
        """(frame, pts_scale, crop) of the anti-aliased decimated scoring
        pass: the binomial-blurred frame, stride-downsampled with
        `score_downsample`."""
        s = self.pf.score_stride
        if frame.dim() == 4:
            # per-tracker frames, each blurred as `_blur2` blurs one
            fr_b = _blur_windows(frame.permute(0, 3, 1, 2), s).permute(
                0, 2, 3, 1)
        else:
            fr_b = _blur2(frame, s)
        if not self.pf.score_downsample:
            return fr_b, None, None
        crop = (max(32, self.prm.crop // s + 16)
                if self.prm.crop is not None else None)
        sub = fr_b[:, ::s, ::s] if frame.dim() == 4 else fr_b[::s, ::s]
        return sub.contiguous(), 1.0 / s, crop

    def _log_lik(self, am_state, patch, am=None, p_am=None):
        """(B, P) log-likelihoods of patches (B, P, N, C) against the
        particle view of an AM state; `p_am` (B, P, P_am), the photometric
        particles, replaces its parameters where it has any."""
        am = am or self.am
        if p_am is not None and p_am.shape[-1] > 0:
            am_state = am_state._replace(p_am=p_am)
        if self.pf.likelihood == "am":
            return torch.log(am.likelihood(am_state, patch) + 1e-30)
        f = am.f(am_state, patch)
        if self.pf.likelihood == "gaussian":
            return f / (2.0 * self.pf.measurement_sigma ** 2)
        # reciprocal: 1 / (1 - f) for similarities peaking at high f
        return -torch.log1p(-f + 1e-6)

    # -- API -----------------------------------------------------------
    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        P = self.pf.n_particles
        B = state.ssm_state.shape[0]
        particles = state.ssm_state[:, None].expand(
            B, P, self.ssm.dof).contiguous()
        D = max(1, len(self.pf.ssm_sigmas))
        score = None
        if self.score_idx is not None:
            region = state.region
            if self.pf.score_blur and frame.dim() == 2:
                # the blurred (and downsampled) init frame at the
                # decimated points
                fr_b, pscale, _ = self._score_frame(frame)
                pts = W.apply_warp(region.norm_mat,
                                   region.base_pts[:, self.score_idx])
                if pscale is not None:
                    pts = pts * pscale
                score = self._score_am.init(interp.sample(
                    fr_b, pts, self.prm.interp, self.prm.border))
            else:
                score = self._score_am.init(
                    state.am_state.template[:, self.score_idx])
        dev = self.device
        return PFState(
            particles=particles, prev_particles=particles.clone(),
            log_weights=torch.full((B, P), -math.log(P), device=dev),
            step=torch.zeros((), dtype=torch.int64),
            distr_log_w=torch.full((B, D), -math.log(D), device=dev),
            am_particles=(state.am_state.p_am[:, None].expand(
                B, P, -1).contiguous() if self._sample_am
                else torch.zeros((B, P, 0), device=dev)),
            score_am=score)

    def _effective_sigma(self, state: TrackerState,
                         frame: torch.Tensor) -> torch.Tensor:
        """(B, S) sampler sigmas; with `jacobian_as_sigma` the magnitude of
        one Gauss-Newton step at the current state, floored at a tenth of
        the configured sigma (NT/PF.cc:214-227)."""
        ssm, pf = self.ssm, self.pf
        sigma = self._sigma(state.region)
        if not pf.jacobian_as_sigma:
            return sigma
        region = state.region
        comp = pf.update_type == "compositional"

        def pts_fn(s, dp, bp, nm):
            return W.apply_warp(nm, ssm.warp_pts_from(s, dp, bp, comp))

        zero = torch.zeros_like(state.ssm_state)
        jpts = torch.func.vmap(torch.func.jacfwd(pts_fn, argnums=1))(
            state.ssm_state, zero, region.base_pts, region.norm_mat)
        pts0 = pts_fn(state.ssm_state, zero, region.base_pts,
                      region.norm_mat)
        patch, grad = interp.sample_val_grad(frame, pts0, self.prm.interp,
                                             self.prm.border)
        B, S = zero.shape
        J = torch.einsum("bncd,bnds->bncs", grad, jpts).reshape(B, -1, S)
        g = self.am.grad_corrected(state.am_state, patch).reshape(B, -1)
        H = J.transpose(1, 2) @ J + 1e-6 * torch.eye(S, device=J.device)
        step = torch.linalg.solve_ex(H, (g[:, None] @ J)[:, 0])[0]
        return torch.maximum(step.abs(), 0.1 * sigma)

    def _draw_sigmas(self, gumbel, distr_log_w, sigma):
        """(d_idx (B, P), sig_p (B, P, S)): one of the D preset
        distributions per particle, drawn from the tracker's adaptive
        distribution weights (categorical by the Gumbel trick, as
        `jax.random.categorical`), or the one sigma."""
        pf = self.pf
        P = gumbel.shape[0]
        B, S = sigma.shape
        if pf.ssm_sigmas and not pf.jacobian_as_sigma:
            sigmas = torch.as_tensor(pf.ssm_sigmas, dtype=torch.float32,
                                     device=sigma.device)      # (D, S)
            d_idx = torch.argmax(gumbel[None] + distr_log_w[:, None, :],
                                 dim=-1)
            return d_idx, sigmas[d_idx]
        return (torch.zeros((B, P), dtype=torch.int64, device=sigma.device),
                sigma[:, None].expand(B, P, S))

    def _propagate_measure(self, state, frame, noise, particles,
                           prev_particles, sig_p, am_prop=None):
        """Propagate and measure: (prop (B, P, S), log_lik (B, P),
        valid (B, P)) of this rank's particles (`_mine`)."""
        ssm, pf = self.ssm, self.pf
        comp = pf.update_type == "compositional"
        if pf.dynamic_model == "ar1":
            prop = ssm.auto_regression1(noise, particles, prev_particles,
                                        sig_p, pf.ar_alpha, comp)
        else:
            prop = ssm.random_walk(noise, particles, sig_p, comp)
        ps: PFState = state.extra
        region = state.region
        if self.score_idx is not None and ps.score_am is not None:
            bp = region.base_pts[:, self.score_idx]
            sc_am, sc_st = self._score_am, ps.score_am
        else:
            bp, sc_am, sc_st = None, self.am, state.am_state
        frame_sc, pscale, crop_sc = frame, None, None
        if bp is not None and pf.score_blur and is_gray(frame):
            frame_sc, pscale, crop_sc = self._score_frame(frame)
        patches, valid = self._particle_patches(
            region, prop, frame_sc, base_pts=bp, pts_scale=pscale,
            crop=crop_sc, extent=self._extent)
        log_lik = self._log_lik(_particle_view(sc_st), patches, am=sc_am,
                                p_am=am_prop)
        K = pf.rescore_top_k
        if K > 0 and bp is not None:
            # the coarse pass ranks; the top K are re-scored at full
            # resolution and carry the weights, the rest get -1e30 (a
            # particle that leaves the rescore window is dropped too)
            P = prop.shape[1]
            llc = self._apply_window_mask(log_lik, valid)
            topi = torch.topk(llc, min(K, P), dim=-1).indices   # (B, K)
            patches_k, valid_k = self._particle_patches(
                region, _take(prop, topi), frame,
                crop=pf.rescore_crop or None)
            ll_k = self._log_lik(
                _particle_view(state.am_state), patches_k,
                p_am=None if am_prop is None else _take(am_prop, topi))
            log_lik = torch.full_like(log_lik, _NEG).scatter(1, topi, ll_k)
            valid = torch.zeros_like(valid).scatter(1, topi, valid_k)
        return prop, log_lik, valid

    # -- the particle population: all of it here; `ShardedPF` holds and
    # measures its rank's rows and gathers the rest
    _extent = None

    def _mine(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's particles of a whole-population tensor."""
        return x

    def _all(self, x: torch.Tensor) -> torch.Tensor:
        """The whole population (B, P, ...) of this rank's (B, P', ...)."""
        return x

    @staticmethod
    def _apply_window_mask(log_lik, valid):
        """Particles outside the sampling window score -1e30, unless all
        of a tracker's particles left it (then its raw scores stand)."""
        return torch.where(valid.any(dim=-1, keepdim=True),
                           torch.where(valid, log_lik,
                                       torch.full_like(log_lik, _NEG)),
                           log_lik)

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        ps: PFState = state.extra
        sigma = self._effective_sigma(state, frame)
        dr = self._draw(int(ps.step))
        d_idx, sig_p = self._draw_sigmas(dr.gumbel, ps.distr_log_w, sigma)
        am_prop = ps.am_particles
        if self._sample_am:
            # the photometric random walk, one draw shared by the trackers
            am_prop = am_prop + torch.as_tensor(
                self.pf.am_sigma, dtype=am_prop.dtype,
                device=am_prop.device) * self._mine(dr.am)[None]
        prop, log_lik, valid = self._propagate_measure(
            state, frame, self._mine(dr.prop)[None], ps.particles,
            ps.prev_particles, self._mine(sig_p, 1), am_prop)
        # the tables below are small: the whole population's, on every rank
        prop, am_prop = self._all(prop), self._all(am_prop)
        log_lik = self._apply_window_mask(self._all(log_lik),
                                          self._all(valid))
        log_w = self._all(ps.log_weights) + log_lik
        log_w = log_w - torch.logsumexp(log_w, dim=-1, keepdim=True)
        prop, prev_out, am_prop, log_w, new_dlw, mean_state = self._finish(
            state, prop, self._all(ps.particles), am_prop, log_w, d_idx,
            ps.distr_log_w, dr.u0)
        am_state = state.am_state
        if self._sample_am:
            # the weighted mean of the photometric particles (additive)
            w = torch.exp(log_w - torch.logsumexp(log_w, dim=-1,
                                                  keepdim=True))
            am_state = am_state._replace(
                p_am=(w[..., None] * am_prop).sum(dim=1))
        new_am, new_score = self._learn_mean_patch(
            state, am_state, mean_state, frame, ps.score_am)
        new_extra = PFState(particles=self._mine(prop, 1),
                            prev_particles=self._mine(prev_out, 1),
                            log_weights=self._mine(log_w, 1),
                            step=ps.step + 1, distr_log_w=new_dlw,
                            am_particles=self._mine(am_prop, 1),
                            score_am=new_score)
        return state._replace(ssm_state=mean_state, am_state=new_am,
                              extra=new_extra)

    def _learn_mean_patch(self, state, am_state, mean_state, frame,
                          score_am_state=None):
        """Template learning on the mean state's patch, skipped per
        tracker where that patch leaves the window; the decimated scoring
        template learns the same patch's decimated points. A no-op (and no
        sampling) with learning off."""
        if not self.am.needs_update_model:
            return am_state, score_am_state
        patches, pvalid = self._particle_patches(
            state.region, mean_state[:, None], frame)
        ok = pvalid[:, 0]
        new_am = where_state(ok, self.am.update_model(am_state,
                                                      patches[:, 0]),
                             am_state)
        new_score = score_am_state
        if score_am_state is not None:
            if self.pf.score_blur and is_gray(frame):
                fr_b, pscale, crop_sc = self._score_frame(frame)
                patches_b, _ = self._particle_patches(
                    state.region, mean_state[:, None], fr_b,
                    base_pts=state.region.base_pts[:, self.score_idx],
                    pts_scale=pscale, crop=crop_sc)
                sub = patches_b[:, 0]
            else:
                sub = patches[:, 0][:, self.score_idx]
            new_score = where_state(
                ok, self._score_am.update_model(score_am_state, sub),
                score_am_state)
        return new_am, new_score

    def _finish(self, state, prop, prev_particles, am_prop, log_w, d_idx,
                distr_log_w, u0):
        """Adaptive resampling, the distributions' re-weighting and the
        state estimate: (prop, prev_out, am_prop, log_w, new_dlw,
        mean_state)."""
        ssm, pf = self.ssm, self.pf
        P = pf.n_particles
        n_distr = max(1, len(pf.ssm_sigmas))
        w = torch.exp(log_w)
        n_eff = 1.0 / torch.clamp((w * w).sum(dim=-1), min=1e-30)
        if n_distr > 1 and pf.adapt_distr:
            # EMA toward each distribution's share of the likelihood mass
            mass = torch.zeros_like(distr_log_w).scatter_add(1, d_idx, w)
            mass = mass + 1e-6
            new_dlw = torch.log(0.5 * torch.exp(distr_log_w) + 0.5 * mass
                                / mass.sum(dim=-1, keepdim=True))
            new_dlw = new_dlw - torch.logsumexp(new_dlw, dim=-1,
                                                keepdim=True)
        else:
            new_dlw = distr_log_w
        prev_out = prev_particles
        if pf.resampling != "none":
            idx = systematic_indices(log_w, u0)
            do = n_eff < pf.n_eff_ratio * P                       # (B,)
            m = do[:, None, None]
            prop = torch.where(m, _take(prop, idx), prop)
            prev_out = torch.where(m, _take(prev_particles, idx),
                                   prev_particles)
            am_prop = torch.where(m, _take(am_prop, idx), am_prop)
            log_w = torch.where(do[:, None],
                                torch.full_like(log_w, -math.log(P)), log_w)
        w = torch.exp(log_w - torch.logsumexp(log_w, dim=-1, keepdim=True))
        if pf.mean_type == "best":
            mean_state = _take(prop, torch.argmax(log_w, dim=-1)[:, None])[
                :, 0]
        elif pf.mean_type == "corner":
            bc = state.region.base_corners
            corners = ssm.warp_pts(prop, bc[:, None])            # (B, P, 4, 2)
            mean_c = (w[..., None, None] * corners).sum(dim=1)
            mean_state = ssm.fit_pts(bc, mean_c)
        else:
            # Euclidean, or the Karcher mean of the Lie SSMs
            mean_state = ssm.mean_of_samples(prop, w)
        return prop, prev_out, am_prop, log_w, new_dlw, mean_state
