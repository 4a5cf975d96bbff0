"""Linear-predictor search method (port of `mtf_tpu/sm/lp.py`), over B
trackers: hyperplane tracking.

Offline (`initialize`), per tracker and per stage i of `n_stages`: K
warp perturbations dp_k (the stage's sigma, halved per stage, times one
standard-normal draw shared by the trackers), their intensity
differences d_k = I0(w(x, dp_k)) - I0(x), and the ridge predictor in its
dual (K x K) form

    A = P (D^T D + lam I_K)^-1 D^T        (S, N·C), P the targets dp_k^-1,

lam = `ridge` times the mean diagonal of D^T D, one `torch.linalg.solve`
per tracker. Online (`update`), per stage, up to `max_iters` times: one
value-only sample and dp = A (I(w(x, p)) - I0), a compositional step; a
tracker whose corners moved less than `epsilon` freezes for the rest of
the stage (the JAX package's vmapped `while_loop`).

The differences D (B, K, N·C) are built in tracker chunks of at most
`_CHUNK_BYTES` and sample chunks of `_SAMPLES` (dense taps read a `crop`
window per sample). Draws: stage i's normals are a function of (`seed`,
i) alone, on the tracker's device, from `_draw`, which a caller may
override (the parity tests hand it the JAX package's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.sm.core import (SearchMethod, TrackerState, converge,
                                   points_at, sampler_sigma, seeded_generator)

_SAMPLES = 64                # samples per sampling call
_CHUNK_BYTES = 1 << 30       # D's bytes per tracker chunk


@dataclass(frozen=True)
class LPParams:
    """The JAX package's `LPParams` (fields and defaults)."""
    n_samples: int = 512       # K training perturbations
    max_iters: int = 5
    pix_sigma: float = 4.0     # training motion (px)
    ssm_sigma: tuple = ()      # explicit per-dof training sigmas
    ridge: float = 1e-3        # lam over the mean diagonal of D^T D
    epsilon: float = 0.01      # corner-change convergence threshold (px)
    n_stages: int = 3          # stage i trained at sigma * 0.5^i
    seed: int = 0


class LPState(NamedTuple):
    A: torch.Tensor        # (B, n_stages, S, N·C) stacked predictors
    patch0: torch.Tensor   # (B, N, C) template


class LP(SearchMethod):
    name = "lp"
    SALT = 3

    def __init__(self, am, ssm, prm=None, lp: LPParams | None = None):
        super().__init__(am, ssm, prm)
        self.lp = lp or LPParams()

    def _draw(self, stage: int) -> torch.Tensor:
        """Stage `stage`'s (K, S) standard normals (overridable: the
        parity tests hand in the JAX package's)."""
        gen = seeded_generator(self.lp.seed, stage, self.SALT, self.device)
        return torch.randn((self.lp.n_samples, self.ssm.dof), generator=gen,
                           device=self.device)

    def _patch_at(self, region, s, frame):
        """Patches (B, ..., N, C) at states s (B, ..., S): value-only dense
        taps in a `crop` window per state, or the gather sampler."""
        pts = points_at(self.ssm, region, s)
        if self.prm.interp.endswith(interp.MM_SUFFIX):
            return interp.sample_dense(
                frame, pts, self.prm.interp[:-len(interp.MM_SUFFIX)],
                crop=self.prm.crop, need_grad=False)[0]
        return interp.sample(frame, pts, self.prm.interp, self.prm.border)

    def _train_stage(self, region, frame, patch0, sigma, noise):
        """One stage's predictors (B, S, N·C) from noise (K, S)."""
        B, S = sigma.shape
        K = noise.shape[0]
        D_cols = patch0.shape[-2] * patch0.shape[-1]
        chunk = max(1, _CHUNK_BYTES // (4 * K * D_cols))
        eye = torch.eye(K, dtype=noise.dtype, device=noise.device)
        out = []
        for i in range(0, B, chunk):
            sl = slice(i, i + chunk)
            rg = region._replace(norm_mat=region.norm_mat[sl],
                                 base_pts=region.base_pts[sl],
                                 base_corners=region.base_corners[sl])
            dps = sigma[sl, None] * noise[None]                 # (b, K, S)
            p0 = patch0[sl].flatten(1)[:, None]
            D = torch.cat([self._patch_at(rg, dps[:, j:j + _SAMPLES],
                                          frame).flatten(2) - p0
                           for j in range(0, K, _SAMPLES)], dim=1)
            # a patch that matches the template seen under dp is corrected
            # by dp^-1: learn the inverses, as the NN dataset does
            P = self.ssm.invert(dps)                            # (b, K, S)
            G = D @ D.transpose(1, 2)                           # (b, K, K)
            lam = self.lp.ridge * G.diagonal(dim1=-2, dim2=-1).sum(-1) / K
            X = torch.linalg.solve(G + lam[:, None, None] * eye, P)
            out.append(X.transpose(1, 2) @ D)                   # (b, S, NC)
            del D, G
        return torch.cat(out, dim=0)

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        region = state.region
        B = state.ssm_state.shape[0]
        patch0 = self._patch_at(region, self.ssm.identity((B,)), frame)
        sigma = sampler_sigma(self.ssm, region, self.lp.ssm_sigma,
                              self.lp.pix_sigma)
        A = torch.stack([
            self._train_stage(region, frame, patch0, sigma * (0.5 ** i),
                              self._draw(i))
            for i in range(self.lp.n_stages)], dim=1)
        return LPState(A=A, patch0=patch0)

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        ssm, lp = self.ssm, self.lp
        ls: LPState = state.extra
        s = state.ssm_state
        d0 = ls.patch0.flatten(1)

        def dp_of(A):
            return lambda s: (A @ (self._patch_at(state.region, s, frame)
                                   .flatten(1) - d0)[..., None])[..., 0]
        for i in range(lp.n_stages):                # coarse -> fine
            s = converge(ssm, state.region, s, lp.max_iters, lp.epsilon,
                         dp_of(ls.A[:, i]))
        new_state = state._replace(ssm_state=s)
        if not self.am.needs_update_model:
            return new_state
        return new_state._replace(am_state=self.am.update_model(
            state.am_state, self._patch_at(state.region, s, frame)))
