"""Information-theoretic appearance models (port of `mtf_tpu/am/info.py`):
MI, CCRE, KLD and LKLD, over patches (..., N, C).

The cubic B-spline Parzen machinery is `ops/hist.py`; joint histograms
are float32 matmuls of dense (N, n_bins) membership matrices, so
gradients and Hessians come from `torch.func` through the splines. Each
channel has its own histograms (the JAX package's `vmap` over channels is
a channel axis here: memberships (..., C, N, n_bins)); similarities sum
over the channels.
"""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState
from mtf_tpu_torch.ops import hist as H

_EPS = 1e-8


def _per_channel(z: torch.Tensor) -> torch.Tensor:
    """(..., N, C) -> (..., C, N)."""
    return z.transpose(-1, -2)


class MI(AM):
    """Mutual information of a cubic-B-spline Parzen joint histogram."""
    name = "mi"

    def _z(self, patch):
        return H.to_bin_coords(patch, self.prm.n_bins, self.prm.pix_min,
                               self.prm.pix_max, self.prm.pre_seed)

    def _weights(self, patch):
        return H.bspl_weights(_per_channel(self._z(patch)), self.prm.n_bins)

    def _init_extra(self, patch0):
        return (self._weights(patch0),)                # (..., C, N, n_bins)

    def _similarity(self, state: AMState, patch):
        w0 = state.extra[0]
        wt = self._weights(patch)
        return H.mutual_information(H.joint_hist(w0, wt)).sum(dim=-1)

    def likelihood(self, state, patch):
        return torch.exp(self.prm.likelihood_alpha * self.f(state, patch))

    def dist_feat(self, patch):
        """The binned features (..., C·N·n_bins), channel-major."""
        return self._weights(patch).flatten(-3)


class CCRE(AM):
    """Cross-cumulative residual entropy (the reference CCRE.cc form):
    the current image's axis carries cumulative (survival) weights, the
    template's Parzen density weights, every histogram pre-seeded and
    normalised by 1 / (N + n_bins^2 pre_seed)."""
    name = "ccre"

    def _z(self, patch):
        return H.to_bin_coords(patch, self.prm.n_bins, self.prm.pix_min,
                               self.prm.pix_max, 1.0)

    def _init_extra(self, patch0):
        return (H.bspl_weights(_per_channel(self._z(patch0)),
                               self.prm.n_bins),)

    def _cum_weights(self, patch):
        return H.cum_bspl_weights(_per_channel(self._z(patch)),
                                  self.prm.n_bins)

    def _similarity(self, state: AMState, patch):
        w0 = state.extra[0]                            # (..., C, N, B)
        wc = self._cum_weights(patch)
        nb = self.prm.n_bins
        pre = self.prm.pre_seed
        hist_pre = nb * pre
        norm = 1.0 / (w0.shape[-2] + hist_pre * nb)
        joint = (torch.matmul(wc.transpose(-1, -2), w0) + pre) * norm
        cum_h = (wc.sum(dim=-2) + hist_pre) * norm     # (..., C, B)
        init_h = (w0.sum(dim=-2) + hist_pre) * norm
        log_term = (torch.log(joint) - torch.log(cum_h)[..., :, None]
                    - torch.log(init_h)[..., None, :])
        return (joint * log_term).sum(dim=(-3, -2, -1))

    def likelihood(self, state, patch):
        return torch.exp(self.prm.likelihood_alpha * self.f(state, patch))

    def dist_feat(self, patch):
        """The cumulative-weight features (..., C·N·n_bins)."""
        return self._cum_weights(patch).flatten(-3)


class KLD(AM):
    """Negative KL divergence between the template's and the candidate's
    marginal Parzen histograms."""
    name = "kld"

    def _z(self, patch):
        return H.to_bin_coords(patch, self.prm.n_bins, self.prm.pix_min,
                               self.prm.pix_max, self.prm.pre_seed)

    def _marginals(self, patch):
        """(..., N, C) -> (..., C, n_bins)."""
        return H.marginal_hist(H.bspl_weights(_per_channel(self._z(patch)),
                                              self.prm.n_bins))

    def _init_extra(self, patch0):
        return (self._marginals(patch0),)

    @staticmethod
    def _neg_kl(p0, pt):
        return -(p0 * (torch.log(p0 + _EPS) - torch.log(pt + _EPS)))

    def _similarity(self, state: AMState, patch):
        return self._neg_kl(state.extra[0], self._marginals(patch)).sum(
            dim=(-2, -1))


class LKLD(KLD):
    """Localised KLD: the patch split into sub_regions x sub_regions
    blocks, the blocks' KLDs summed."""
    name = "lkld"

    def _blocks(self, patch):
        """(..., N, C) -> (..., k·k, by·bx, C), the JAX package's block
        order (rows of blocks, then columns)."""
        k = self.prm.extra.get("sub_regions", 2)
        ry, rx, c = self.prm.resy, self.prm.resx, patch.shape[-1]
        by, bx = ry // k, rx // k
        lead = patch.shape[:-2]
        img = patch.reshape(lead + (ry, rx, c))[..., : by * k, : bx * k, :]
        n = len(lead)
        blocks = img.reshape(lead + (k, by, k, bx, c)).permute(
            tuple(range(n)) + (n, n + 2, n + 1, n + 3, n + 4))
        return blocks.reshape(lead + (k * k, by * bx, c))

    def _init_extra(self, patch0):
        return (self._marginals(self._blocks(patch0)),)  # (..., K, C, B)

    def _similarity(self, state: AMState, patch):
        pt = self._marginals(self._blocks(patch))
        return self._neg_kl(state.extra[0], pt).sum(dim=(-3, -2, -1))
