"""TrackerFleet: B independent trackers as one batched update (port of
`mtf_tpu/parallel/fleet.py`), optionally sharded over a mesh axis.

The port's search methods are already batched over a leading B axis, so
a fleet is one batched `update` call on the device the tracker was
built on:

    fleet = TrackerFleet(create_tracker("fclk", "ssd", "8", ...,
                                        device="cuda"), donate=True)
    states = fleet.initialize(frame0, corners_batch)   # (B, ...) state
    states = fleet.update(states, frame)               # one shared frame
    states = fleet.update_multi(states, frames)        # one per tracker

With `mesh` (a `DeviceMesh`, `parallel.mesh.make_mesh`) the trackers are
sharded over its axis `axis`: every rank of the axis runs this code
together, each holding and stepping its B/n trackers on the frame it is
given, with no collective; `corners` gathers the whole fleet's.
"""
from __future__ import annotations

import torch

from mtf_tpu_torch.parallel.mesh import tracker_sharding


def _leaf_pairs(dst, src, out: list) -> list:
    """The (old, new) tensor pairs at the same places of states `dst` and
    `src` (same structure of tuples and NamedTuples)."""
    if isinstance(dst, torch.Tensor):
        out.append((dst, src))
    elif isinstance(dst, tuple):
        if not isinstance(src, tuple) or len(src) != len(dst):
            raise ValueError("donate: the update changed the state's "
                             "structure")
        for d, s in zip(dst, src):
            _leaf_pairs(d, s, out)
    elif dst is not None or src is not None:
        raise ValueError(f"donate: cannot write {type(src).__name__} into "
                         f"{type(dst).__name__}")
    return out


def _copy_leaves(dst, src) -> None:
    """Write every tensor of state `src` into the tensor at the same
    place of `dst`; tensors the update carried over unchanged are
    skipped. A new tensor that is another field's old tensor (a particle
    filter without resampling keeps its particles as the next
    `prev_particles`) is copied before any field is written."""
    pairs = [(d, s) for d, s in _leaf_pairs(dst, src, []) if d is not s]
    written = {id(d) for d, _ in pairs}
    pairs = [(d, s.clone() if id(s) in written else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def _donate_ok(dst, src) -> bool:
    """True where every new tensor of `src` fits its old one in `dst` (a
    grid's shared previous frame becomes one per tracker on its first
    `update_multi`)."""
    return all(d.shape == s.shape for d, s in _leaf_pairs(dst, src, []))


class TrackerFleet:
    """Fleet of one tracker program over a batch of regions, optionally
    sharded over `mesh[axis]`."""

    def __init__(self, sm, mesh=None, axis: str = "tracker",
                 donate: bool = False):
        """`donate`: write each update's results into the state tensors
        passed in (steady-state serving, no new state allocations) and
        return that same state; a grid's shared previous frame is copied
        into the state's own buffer, never aliased to the caller's frame
        (an update whose results no longer fit the tensors passed in
        returns a new state). The pre-update values are then gone, so
        leave it False for protocols that reuse old states."""
        self.sm = sm
        self.mesh = mesh
        self.axis = axis
        self.donate = donate
        self.shard = (None if mesh is None
                      else tracker_sharding(mesh, axis))

    def _local(self, x):
        """This rank's rows of a whole-fleet (B, ...) batch."""
        return x if self.shard is None else self.shard.local(x)

    def _donated(self, states, new):
        if not self.donate or not _donate_ok(states, new):
            return new
        _copy_leaves(states, new)
        return states

    def initialize(self, frame, corners_batch):
        """corners_batch: (B, 4, 2) of the whole fleet; one shared init
        frame. A sharded fleet initialises its own rows."""
        return self.sm.initialize(frame, self._local(corners_batch))

    def update(self, states, frame):
        """One fleet step on a shared frame."""
        return self._donated(states, self.sm.update(states, frame))

    def update_multi(self, states, frames):
        """One fleet step, each tracker on its own frame: frames
        (B, H, W[, C]) of the whole fleet (a sharded fleet steps its own
        rows), batched as `update` is."""
        return self._donated(states, self.sm.update_multi(
            states, self._local(frames)))

    def corners(self, states) -> torch.Tensor:
        """(B, 2, 4) corner matrices of the whole fleet."""
        c = self.sm.corners(states)
        return c if self.shard is None else self.shard.gather(c)

    def track_sequence(self, states, frames):
        """Step the fleet over a frame stack (T, H, W[, C]) shared by the
        trackers: (the final states, the corners (T, B, 2, 4) after each
        update)."""
        out = []
        for frame in frames:
            states = self.update(states, frame)
            out.append(self.corners(states))
        return states, torch.stack(out)
