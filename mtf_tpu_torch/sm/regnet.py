"""RegNet: the learned regression search method (port of
`mtf_tpu/sm/regnet.py`), over B trackers.

At `initialize` each tracker samples K views of its template under
perturbations dp (its sigma times one standard-normal draw shared by the
trackers), takes their distance features relative to the template's,
scaled by the template features' population std, and trains a tanh MLP
to map them to dp^-1 / sigma: `train_steps` Adam steps (optax's
defaults: b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on minibatches of
`batch_size` samples, the loss each tracker's mean squared error. The
MLP of B trackers is one (B, in, out) weight and (B, out) bias per layer,
applied by batched matmuls, and trained as one: the sum of the trackers'
losses has each tracker's gradient in its own weights. An update applies
the MLP up to `max_iters` times, a compositional step of its output times
sigma; a tracker whose corners moved less than `epsilon` freezes.

Draws (`RegNetDraw`): the perturbations' normals, the initial weights
(normal / sqrt(fan-in), zero biases) and the minibatch indices, shared by
the trackers as a JAX fleet's one key, a function of `seed` alone on the
tracker's device, from `_draw`, which a caller may override (the parity
tests hand it the JAX package's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.sm.core import (SearchMethod, TrackerState, converge,
                                   points_at, sampler_sigma, seeded_generator)

_SAMPLES = 256               # samples per sampling call


@dataclass(frozen=True)
class RegNetParams:
    """The JAX package's `RegNetParams` (fields and defaults)."""
    n_samples: int = 2000
    hidden: tuple = (128, 64)
    train_steps: int = 300
    batch_size: int = 256
    learning_rate: float = 1e-3
    pix_sigma: float = 4.0
    ssm_sigma: tuple = ()
    max_iters: int = 5
    epsilon: float = 0.01
    seed: int = 0


class RegNetState(NamedTuple):
    params: tuple               # per layer (W (B, in, out), b (B, out))
    feat0: torch.Tensor         # (B, D) template features
    feat_scale: torch.Tensor    # (B,) their population std, floored


class RegNetDraw(NamedTuple):
    """The draws of one tracker's training, shared by the fleet."""
    dps: torch.Tensor           # (K, S) standard normals
    weights: tuple              # per layer (in, out) initial weights
    idx: torch.Tensor           # (train_steps, batch_size) int64 indices


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x (B, M, in) through the layers, tanh between them -> (B, M, out)."""
    for i, (w, b) in enumerate(params):
        x = torch.baddbmm(b[:, None], x, w)
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def adam_step(params, grads, mu, nu, count: int, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step (optax.adam) over tuples of tensors -> (params, mu,
    nu); `count` is the step's 1-based count."""
    mu = tuple(b1 * m + (1.0 - b1) * g for m, g in zip(mu, grads))
    nu = tuple(b2 * v + (1.0 - b2) * g * g for v, g in zip(nu, grads))
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    params = tuple(p - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
                   for p, m, v in zip(params, mu, nu))
    return params, mu, nu


class RegNet(SearchMethod):
    name = "regnet"
    SALT = 4

    def __init__(self, am, ssm, prm=None, rn: RegNetParams | None = None):
        super().__init__(am, ssm, prm)
        self.rn = rn or RegNetParams()

    def _draw(self, sizes: tuple) -> RegNetDraw:
        """The training draws for layer sizes `sizes` (overridable: the
        parity tests hand in the JAX package's)."""
        rn = self.rn
        gen = seeded_generator(rn.seed, 0, self.SALT, self.device)
        kw = dict(generator=gen, device=self.device)
        dps = torch.randn((rn.n_samples, self.ssm.dof), **kw)
        weights = tuple(torch.randn((a, b), **kw) / float(a) ** 0.5
                        for a, b in zip(sizes[:-1], sizes[1:]))
        idx = torch.randint(0, rn.n_samples, (rn.train_steps, rn.batch_size),
                            **kw)
        return RegNetDraw(dps, weights, idx)

    def _sigma(self, region) -> torch.Tensor:
        """(B, S) sigmas."""
        return sampler_sigma(self.ssm, region, self.rn.ssm_sigma,
                             self.rn.pix_sigma)

    def _patch_at(self, region, s, frame):
        """Patches (B, ..., N, C) at states s (B, ..., S), by the sampler
        of `interp` (`interp.sample`, as the JAX package's)."""
        pts = points_at(self.ssm, region, s)
        return interp.sample(frame, pts, self.prm.interp, self.prm.border)

    def _features(self, rs_feat0, rs_scale, patch):
        return (self.am.dist_feat(patch) - rs_feat0) / rs_scale

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        rn, ssm = self.rn, self.ssm
        B, S = state.ssm_state.shape
        region = state.region
        sigma = self._sigma(region)
        feat0 = self.am.dist_feat(self._patch_at(region, ssm.identity((B,)),
                                                 frame))
        scale = torch.clamp(feat0.std(dim=-1, correction=0), min=1e-6)
        sizes = (feat0.shape[-1],) + tuple(rn.hidden) + (S,)
        dr = self._draw(sizes)
        dps = sigma[:, None] * dr.dps[None]                     # (B, K, S)
        X = torch.cat([
            self._features(feat0[:, None], scale[:, None, None],
                           self._patch_at(region, dps[:, j:j + _SAMPLES],
                                          frame))
            for j in range(0, rn.n_samples, _SAMPLES)], dim=1)  # (B, K, D)
        Y = ssm.invert(dps) / torch.clamp(sigma, min=1e-12)[:, None]
        params = tuple(t for w in dr.weights for t in (
            w.expand(B, -1, -1).contiguous(),
            torch.zeros((B, w.shape[1]), dtype=w.dtype, device=w.device)))
        mu = tuple(torch.zeros_like(p) for p in params)
        nu = tuple(torch.zeros_like(p) for p in params)

        def loss(flat, xb, yb):
            pred = mlp_apply(tuple(zip(flat[::2], flat[1::2])), xb)
            return ((pred - yb) ** 2).sum(-1).mean(-1).sum()

        grad = torch.func.grad(loss)
        for t in range(rn.train_steps):
            idx = dr.idx[t]
            params, mu, nu = adam_step(params, grad(params, X[:, idx],
                                                    Y[:, idx]),
                                       mu, nu, t + 1, rn.learning_rate)
        return RegNetState(params=tuple(zip(params[::2], params[1::2])),
                           feat0=feat0, feat_scale=scale)

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        ssm, rn = self.ssm, self.rn
        rs: RegNetState = state.extra
        sigma = self._sigma(state.region)

        def dp_of(s):
            x = self._features(rs.feat0, rs.feat_scale[:, None],
                               self._patch_at(state.region, s, frame))
            return mlp_apply(rs.params, x[:, None])[:, 0] * sigma
        s = converge(ssm, state.region, state.ssm_state, rn.max_iters,
                     rn.epsilon, dp_of)
        new_state = state._replace(ssm_state=s)
        if not self.am.needs_update_model:
            return new_state
        return new_state._replace(am_state=self.am.update_model(
            state.am_state, self._patch_at(state.region, s, frame)))
