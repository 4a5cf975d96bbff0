"""Sharding layer (port of `mtf_tpu/parallel/`): tracker fleets and
device meshes over `torch.distributed`, one process per device (NCCL on
the card, gloo on the CPU).

Axes, as in the JAX package:
    tracker  -- data parallel over independent trackers (`TrackerFleet`)
    particle -- PF particles (`ShardedPF`), all-gathered resampling
    sample   -- NN dataset samples (`ShardedNN`)
    patch    -- grid patches and RANSAC hypotheses (`ShardedGridTracker`)
    pixel    -- a patch's pixels, summed normal equations
                (`sharded_gn_step`)
`multihost` initialises the world (`init_distributed`), spawns one on a
host (`run_world`) and measures the fleet's scaling
(`measure_fleet_scaling`); `dryrun.dryrun` steps every path once.
"""
from mtf_tpu_torch.parallel.mesh import make_mesh, tracker_sharding
from mtf_tpu_torch.parallel.fleet import TrackerFleet
from mtf_tpu_torch.parallel.pf_shard import ShardedPF
from mtf_tpu_torch.parallel.nn_shard import ShardedNN
from mtf_tpu_torch.parallel.grid_shard import ShardedGridTracker
from mtf_tpu_torch.parallel.patch_shard import sharded_gn_step

__all__ = [
    "make_mesh", "tracker_sharding", "TrackerFleet", "ShardedPF",
    "ShardedNN", "ShardedGridTracker", "sharded_gn_step",
]
