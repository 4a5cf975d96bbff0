"""Faults planted under the timed path, each of which `correct` has to
catch: a wrapper of the fleet that breaks its step.

    unchanged  the step returns the trackers' state unchanged
    half       the second half of the batch is left out: its trackers
               keep their state
    altered    every answer is altered where it is produced: each
               tracker's translation moves by ALTER template units
               (about 0.4-0.9 px at the targets' scales)

The cells run on one chip, so no exchange between chips can be left
out."""
from __future__ import annotations

ALTER = 0.01
KINDS = ("unchanged", "half", "altered")


class Faulty:
    """A `TrackerFleet` whose step carries fault `kind`."""

    def __init__(self, fleet, kind: str):
        if kind not in KINDS:
            raise ValueError(f"unknown fault {kind!r}; known: {KINDS}")
        self.fleet, self.kind = fleet, kind

    def initialize(self, frame, corners):
        return self.fleet.initialize(frame, corners)

    def corners(self, states):
        return self.fleet.corners(states)

    def update(self, states, frame):
        return self._step(self.fleet.update, states, frame)

    def update_multi(self, states, frames):
        return self._step(self.fleet.update_multi, states, frames)

    def _step(self, fn, states, frames):
        if self.kind == "unchanged":
            return states
        old = states.ssm_state.clone()
        new = fn(states, frames)
        if self.kind == "half":
            h = old.shape[0] // 2
            new.ssm_state[h:] = old[h:]
        else:
            new.ssm_state[:, 0] += ALTER
        return new


def planting(kind: str):
    """The `fault` argument of `cell.run_cell` that plants `kind`."""
    return lambda fleet: Faulty(fleet, kind)
