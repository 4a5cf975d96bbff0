"""Sum-of-conditional-variance appearance models (port of
`mtf_tpu/am/scv.py`): SCV, RSCV, LSCV and LRSCV, over patches (..., N, C).

SSD after an intensity remap taken from the joint Parzen histogram of
template and candidate (`ops/hist.py`): the template remapped toward the
candidate (SCV), the candidate toward the template (RSCV), or either one
per sub-region (LSCV, LRSCV). The remap table is recomputed inside f and
held constant (`.detach()`, the JAX package's `stop_gradient`); RSCV's
remap carries the identity's slope (straight-through). Each channel has
its own table: bin coordinates are laid out (..., C, N).
"""
from __future__ import annotations

import torch

from mtf_tpu_torch.am.base import AM, AMState
from mtf_tpu_torch.ops import hist as H


def _remap_table(z_src: torch.Tensor, z_dst: torch.Tensor, n_bins: int,
                 eps: float = 1e-8) -> torch.Tensor:
    """E[dst | src bin] (..., n_bins) in bin coordinates from bin
    coordinates (..., N); an empty source bin maps to itself."""
    w_src = H.bspl_weights(z_src, n_bins)                 # (..., N, nb)
    w_dst = H.bspl_weights(z_dst, n_bins)
    joint = torch.matmul(w_src.transpose(-1, -2), w_dst)  # (..., nb, nb)
    bins = torch.arange(n_bins, dtype=z_src.dtype, device=z_src.device)
    denom = joint.sum(dim=-1)
    table = (joint * bins).sum(dim=-1) / (denom + eps)
    return torch.where(denom > eps, table, bins)


def _apply_table(table: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The remap table (..., nb) linearly interpolated at bin coordinates
    z (...', N), the leading dims broadcast; NaN where z is NaN (a
    diverged tracker's patch), whose index is taken as 0."""
    n_bins = table.shape[-1]
    lead = torch.broadcast_shapes(table.shape[:-1], z.shape[:-1])
    z = z.expand(lead + z.shape[-1:])
    zi = torch.clamp(torch.floor(z), 0, n_bins - 2)
    fz = z - zi
    idx = torch.nan_to_num(zi, nan=0.0).long()
    tab = table.expand(lead + (n_bins,))
    lo = torch.gather(tab, -1, idx)
    hi = torch.gather(tab, -1, idx + 1)
    return lo * (1.0 - fz) + hi * fz


class SCV(AM):
    """Template remapped toward the candidate, then SSD in bin
    coordinates."""
    name = "scv"

    def _z(self, patch: torch.Tensor) -> torch.Tensor:
        """(..., N, C) -> bin coordinates (..., C, N)."""
        return H.to_bin_coords(patch, self.prm.n_bins, self.prm.pix_min,
                               self.prm.pix_max,
                               self.prm.pre_seed).transpose(-1, -2)

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        z0, zt = self._z(state.template), self._z(patch)
        table = _remap_table(z0, zt.detach(), self.prm.n_bins).detach()
        r = zt - _apply_table(table, z0)
        return -0.5 * (r * r).sum(dim=(-2, -1))

    def likelihood(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """exp(-alpha * the RMS residual), as SSD's."""
        f = self.f(state, patch)
        n = state.template.shape[-2] * state.template.shape[-1]
        return torch.exp(-self.prm.likelihood_alpha
                         * torch.sqrt(torch.clamp(-2.0 * f / n, min=0.0)))


class RSCV(SCV):
    """Reverse SCV: the candidate remapped toward the template; the
    gradient flows through the identity part of the remap (the
    reference's `mapped_gradient=false`)."""
    name = "rscv"

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        z0, zt = self._z(state.template), self._z(patch)
        ztc = zt.detach()
        table = _remap_table(ztc, z0, self.prm.n_bins).detach()
        ztm = zt + (_apply_table(table, ztc) - zt).detach()
        r = ztm - z0
        return -0.5 * (r * r).sum(dim=(-2, -1))


class _Localized:
    """Sub-region blocks of LSCV and LRSCV (default 3 x 3); the last
    `res % k` rows and columns are dropped, as the JAX reshape does."""

    def _blocks(self, patch: torch.Tensor) -> torch.Tensor:
        """(..., N, C) -> (..., k·k, by·bx, C), blocks in the JAX
        package's order (rows of blocks, then columns)."""
        k = self.prm.extra.get("sub_regions", 3)
        ry, rx, c = self.prm.resy, self.prm.resx, patch.shape[-1]
        by, bx = ry // k, rx // k
        lead = patch.shape[:-2]
        img = patch.reshape(lead + (ry, rx, c))[..., : by * k, : bx * k, :]
        n = len(lead)
        blocks = img.reshape(lead + (k, by, k, bx, c)).permute(
            tuple(range(n)) + (n, n + 2, n + 1, n + 3, n + 4))
        return blocks.reshape(lead + (k * k, by * bx, c))

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        per_block = super()._similarity(
            AMState(self._blocks(state.template), state.p_am),
            self._blocks(patch))
        return per_block.sum(dim=-1)


class LSCV(_Localized, SCV):
    """SCV with an independent remap per sub-region."""
    name = "lscv"


class LRSCV(_Localized, RSCV):
    """RSCV with an independent remap per sub-region."""
    name = "lrscv"
