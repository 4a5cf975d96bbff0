"""TrackerFleet: B independent trackers stepped on one shared frame
(port of `mtf_tpu/parallel/fleet.py`, single device).

The port's search methods are already batched over a leading B axis, so
a fleet is one batched `update` call on the device the tracker was
built on:

    fleet = TrackerFleet(create_tracker("fclk", "ssd", "8", ...,
                                        device="cuda"), donate=True)
    states = fleet.initialize(frame0, corners_batch)   # (B, ...) state
    states = fleet.update(states, frame)
"""
from __future__ import annotations

import torch


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


class TrackerFleet:
    """Fleet of one tracker program over a batch of regions."""

    def __init__(self, sm, donate: bool = False):
        """`donate`: write each update's results into the state tensors
        passed in (steady-state serving, no new state allocations) and
        return that same state; a grid's shared previous frame is copied
        into the state's own buffer, never aliased to the caller's frame.
        The pre-update values are then gone, so leave it False for
        protocols that reuse old states."""
        self.sm = sm
        self.donate = donate

    def initialize(self, frame, corners_batch):
        """corners_batch: (B, 4, 2); one shared init frame."""
        return self.sm.initialize(frame, corners_batch)

    def update(self, states, frame):
        """One fleet step on a shared frame."""
        new = self.sm.update(states, frame)
        if not self.donate:
            return new
        _copy_leaves(states, new)
        return states

    def corners(self, states) -> torch.Tensor:
        """(B, 2, 4) corner matrices."""
        return self.sm.corners(states)
