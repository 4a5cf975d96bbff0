"""Particle filter with the particle population sharded over a mesh axis
(port of `mtf_tpu/parallel/pf_shard.py`).

The expensive part of a PF update, each particle's propagation, patch
and likelihood (`PF._propagate_measure`), runs on this rank's P/n
particles. The cheap cross-particle part (weight normalisation, the
ESS test, systematic resampling, the sampler distributions' weights,
the mean state: `PF._finish`) runs on tiny (B, P, S <= 8) tables, so
they are all-gathered and the same full-population code runs
replicated on every rank, each keeping its slice. Every draw is the
PF's own whole draw (`PF._draw`), sliced per rank, and the crop window
of the measurement is anchored on the whole population's point cloud
(an all-reduce of its extent), so for the same seed a ShardedPF update
is the PF's update: the particles and weights as the PF's, and its
mean within float32 rounding of the gathered sums.

Full PF feature parity, as in the JAX package: the multi-distribution
samplers (`ssm_sigmas`), the photometric walk (`am_sigma`),
`jacobian_as_sigma` (computed replicated) and every mean type; not the
top-K rescore, which needs a global top-K across shards.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mtf_tpu_torch.parallel.mesh import all_reduce, axis_shard
from mtf_tpu_torch.sm.core import TrackerState
from mtf_tpu_torch.sm.pf import PF, PFState


class ShardedPF(PF):
    """PF whose particle axis is sharded over `mesh[axis]`. Public API
    identical to `PF`; `n_particles` must be divisible by the axis
    size. Its states hold this rank's particles (`place` lays out a PF
    state)."""

    def __init__(self, am, ssm, prm=None, pf=None, *, mesh,
                 axis: str = "particle"):
        super().__init__(am, ssm, prm, pf)
        if self.pf.rescore_top_k > 0:
            raise ValueError(
                "PFParams.rescore_top_k needs a global top-k across "
                "particle shards and is not supported by ShardedPF; "
                "use score_stride-only decimation or the unsharded PF")
        self.mesh = mesh
        self.axis = axis
        self.shard = axis_shard(mesh, axis)
        if self.pf.n_particles % self.shard.size != 0:
            raise ValueError(
                f"n_particles={self.pf.n_particles} not divisible by "
                f"mesh axis {axis!r} size {self.shard.size}")

    def _mine(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.shard.local(x, dim)

    def _all(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(x, 1)

    def _extent(self, ext: torch.Tensor) -> torch.Tensor:
        return all_reduce(ext, dist.ReduceOp.MIN, self.shard.group)

    def place(self, state: TrackerState) -> TrackerState:
        """A PF state (every particle) with this rank's particles."""
        ps: PFState = state.extra
        return state._replace(extra=ps._replace(
            particles=self._mine(ps.particles, 1),
            prev_particles=self._mine(ps.prev_particles, 1),
            log_weights=self._mine(ps.log_weights, 1),
            am_particles=self._mine(ps.am_particles, 1)))

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        return self.place(state._replace(
            extra=super()._init_extra(state, frame))).extra
