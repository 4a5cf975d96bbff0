"""Device meshes over `torch.distributed` (port of
`mtf_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a `jax.sharding.Mesh` and runs
`shard_map` over it. Here every device is a process (one rank per GPU
under NCCL, or per CPU worker under gloo; `multihost.init_distributed`),
the mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dims carry
the JAX axis names ("tracker", "particle", "sample", "patch", "pixel"),
and each JAX collective is the `torch.distributed` call on the axis's
group:

    all_gather(tiled=True)  ->  `gather_cat` (`all_gather`, concatenated)
    psum                    ->  `all_reduce(SUM)`
    pmin / pmax             ->  `all_reduce(MIN / MAX)`
    axis_index              ->  the rank in the axis's group

A population sharded over an axis keeps rows [i·n/k, (i+1)·n/k) on the
rank of index i of k (`AxisShard.local`), so gathering the shards in
rank order restores the unsharded order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mtf_tpu_torch._device import resolve


def make_mesh(axes: dict[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A mesh from `{axis_name: size}` over the ranks of the initialised
    world; -1 absorbs the remaining ranks. Default: every rank on one
    `tracker` axis. A mesh smaller than the world takes its first ranks
    (the others hold no coordinate in it). Every rank of the world
    calls this together. `device_type`: "cuda" (the default) or "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "mtf_tpu_torch.parallel.multihost."
                           "init_distributed first")
    n = dist.get_world_size()
    if not axes:
        axes = {"tracker": n}
    names = list(axes.keys())
    sizes = [int(v) for v in axes.values()]
    if -1 in sizes:
        fixed = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // max(fixed, 1)
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, have {n}")
    device_type = device_type or resolve(None).type
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=tuple(names))


def gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards x of every rank of `group`, concatenated along `dim` in
    rank order (`jax.lax.all_gather(..., tiled=True)`)."""
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """`x` reduced over `group` by `op` (a `dist.ReduceOp`), as a new
    tensor."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class AxisShard(NamedTuple):
    """This rank's place on one mesh axis: the axis's group, the rank's
    index in it and the axis's size."""
    group: object
    index: int
    size: int

    def rows(self, n: int) -> slice:
        """This rank's rows of a population of n, which must divide."""
        if n % self.size:
            raise ValueError(f"{n} rows are not divisible by the mesh "
                             f"axis's {self.size} ranks")
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)

    def local(self, x, dim: int = 0):
        """This rank's rows of x (a tensor or array) along `dim`."""
        idx = (slice(None),) * dim + (self.rows(x.shape[dim]),)
        return x[idx]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of the axis, in order (`gather_cat`)."""
        return gather_cat(x, dim, self.group)


def axis_shard(mesh: DeviceMesh, axis: str) -> AxisShard:
    """This rank's `AxisShard` on `mesh`'s axis `axis`."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes: "
                         f"{mesh.mesh_dim_names}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    d = mesh.mesh_dim_names.index(axis)
    return AxisShard(mesh.get_group(axis), mesh.get_local_rank(axis),
                     mesh.shape[d])


def tracker_sharding(mesh: DeviceMesh, axis: str = "tracker") -> AxisShard:
    """The sharding of a leading batch-of-trackers axis: this rank's
    slice of it (`AxisShard.local`) and the gather of every rank's
    (`AxisShard.gather`)."""
    return axis_shard(mesh, axis)


class Replicated(NamedTuple):
    """A value replicated over a mesh (`put`: the mesh's first rank's,
    broadcast to every rank of the mesh)."""
    mesh: DeviceMesh

    def put(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast x in place from the mesh's first rank, one mesh dim
        after the other, and return it."""
        for name in self.mesh.mesh_dim_names:
            g = self.mesh.get_group(name)
            dist.broadcast(x, dist.get_global_rank(g, 0), group=g)
        return x


def replicated(mesh: DeviceMesh) -> Replicated:
    """The replicated layout of `mesh` (a frame every rank steps on)."""
    return Replicated(mesh)
