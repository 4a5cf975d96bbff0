"""RIU, NGF, PCA and SumOfAMs (port of `mtf_tpu/am/misc.py`), over
patches (..., N, C)."""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState


class RIU(AM):
    """Ratio image uniformity: f = -var(r) / mean(r)^2 with r = (It + 1) /
    (I0 + 1) over every point and channel (population variance)."""
    name = "riu"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        r = (patch + 1.0) / (state.template + 1.0)
        mu = r.mean(dim=(-2, -1))
        var = r.var(dim=(-2, -1), correction=0)
        return -var / (mu * mu + 1e-12)

    def likelihood(self, state, patch):
        return torch.exp(self.prm.likelihood_alpha * self.f(state, patch))


class NGF(AM):
    """Normalised gradient fields: the squared cosine of the eta-
    regularised gradient directions of template and candidate, summed.
    The gradients are central differences on the (resy, resx) point grid,
    one-sided at its edges (`torch.gradient`, as `jnp.gradient`), so NGF
    needs the full grid."""
    name = "ngf"

    def _grad_feat(self, patch: torch.Tensor) -> torch.Tensor:
        """(..., N, C) -> (..., N, C, 2), (d/dx, d/dy)."""
        ry, rx = self.prm.resy, self.prm.resx
        lead, c = patch.shape[:-2], patch.shape[-1]
        img = patch.reshape(lead + (ry, rx, c))
        gy, gx = torch.gradient(img, dim=(-3, -2))
        return torch.stack([gx.reshape(lead + (ry * rx, c)),
                            gy.reshape(lead + (ry * rx, c))], dim=-1)

    def _init_extra(self, patch0):
        return (self._grad_feat(patch0),)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        eta = self.prm.extra.get("eta", 5.0)
        g0 = state.extra[0]
        gt = self._grad_feat(patch)
        dot = (g0 * gt).sum(dim=-1)
        n0 = (g0 * g0).sum(dim=-1) + eta * eta
        nt = (gt * gt).sum(dim=-1) + eta * eta
        return (dot * dot / (n0 * nt)).sum(dim=(-2, -1))

    def likelihood(self, state, patch):
        return torch.exp(self.prm.likelihood_alpha * self.f(state, patch)
                         / (self.prm.resx * self.prm.resy))


class PCA(AM):
    """Online subspace model: -1/2 the residual energy of the patch minus
    the mean outside an eigenbasis, refitted by SVD every `batch_size`
    updates from a buffer of the latest patches, per tracker.

    extra = (mean (B, D), basis (B, D, K), buffer (B, batch, D), count
    (B,) int32), D = N·C (n·C + c)."""
    name = "pca"

    @property
    def _k(self) -> int:
        return self.prm.extra.get("n_eigenvec", 16)

    @property
    def _batch(self) -> int:
        return self.prm.extra.get("batch_size", 30)

    def _init_extra(self, patch0):
        lead = patch0.shape[:-2]
        d = patch0.shape[-2] * patch0.shape[-1]
        kw = dict(dtype=patch0.dtype, device=patch0.device)
        return (patch0.flatten(-2),
                torch.zeros(lead + (d, self._k), **kw),
                torch.zeros(lead + (self._batch, d), **kw),
                torch.zeros(lead, dtype=torch.int32, device=patch0.device))

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        mean, basis, _, _ = state.extra
        r = patch.flatten(-2) - mean
        proj = (r[..., None, :] @ basis)[..., 0, :]
        return -0.5 * ((r * r).sum(dim=-1) - (proj * proj).sum(dim=-1))

    @property
    def needs_update_model(self) -> bool:
        return True            # PCA always collects patches for its refit

    def update_model(self, state: AMState, patch: torch.Tensor) -> AMState:
        """Write the patch (B, N, C) into each tracker's ring buffer; a
        tracker whose count reaches a multiple of `batch_size` refits its
        mean and basis (the buffer's top right singular vectors)."""
        mean, basis, buf, count = state.extra
        b = torch.arange(buf.shape[0], device=buf.device)
        buf = buf.clone()
        buf[b, (count % self._batch).long()] = patch.flatten(-2)
        count = count + 1
        refit = (count >= self._batch) & (count % self._batch == 0)
        if bool(refit.any()):
            new_mean = buf.mean(dim=1)
            vt = torch.linalg.svd(buf - new_mean[:, None],
                                  full_matrices=False).Vh
            k = min(self._k, vt.shape[1])
            new_basis = torch.zeros_like(basis)
            new_basis[..., :k] = vt[:, :k].transpose(1, 2)
            mean = torch.where(refit[:, None], new_mean, mean)
            basis = torch.where(refit[:, None, None], new_basis, basis)
        return state._replace(extra=(mean, basis, buf, count))

    def likelihood(self, state, patch):
        f = self.f(state, patch)
        n = state.template.shape[-2] * state.template.shape[-1]
        return torch.exp(-self.prm.likelihood_alpha
                         * torch.sqrt(torch.clamp(-2.0 * f / n, min=0.0)))


class SumOfAMs(AM):
    """Weighted sum of two AMs' similarities on the same patch, each
    against its own sub-state (extra = (state 1, state 2)); the product of
    their likelihoods; their distance features concatenated."""
    name = "sum"

    def __init__(self, am1: AM, am2: AM, w1: float = 0.5, w2: float = 0.5):
        super().__init__(am1.prm, am1.ilm)
        self.am1, self.am2 = am1, am2
        self.w1, self.w2 = w1, w2
        self.name = f"sum({am1.name},{am2.name})"

    def init(self, patch0: torch.Tensor) -> AMState:
        return AMState(template=patch0,
                       p_am=self.ilm.identity_params(
                           patch0.shape[:-2], patch0.dtype, patch0.device),
                       extra=(self.am1.init(patch0), self.am2.init(patch0)))

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        s1, s2 = state.extra
        return (self.w1 * self.am1._similarity(s1, patch)
                + self.w2 * self.am2._similarity(s2, patch))

    def likelihood(self, state, patch):
        s1, s2 = state.extra
        return self.am1.likelihood(s1, patch) * self.am2.likelihood(s2, patch)

    def dist_feat(self, patch):
        return torch.cat([self.am1.dist_feat(patch),
                          self.am2.dist_feat(patch)], dim=-1)

    @property
    def needs_update_model(self) -> bool:
        return self.am1.needs_update_model or self.am2.needs_update_model

    def update_model(self, state, patch):
        s1, s2 = state.extra
        return state._replace(extra=(self.am1.update_model(s1, patch),
                                     self.am2.update_model(s2, patch)))

    def self_state(self, patch, p_am):
        return AMState(template=patch, p_am=p_am,
                       extra=(self.am1.self_state(patch, p_am),
                              self.am2.self_state(patch, p_am)))
