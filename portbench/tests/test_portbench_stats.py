"""The end-to-end statistics: the rate is all the work of the window over
all of its time, the 95th percentile is over every step, and a stall
planted under the timed path moves both."""
import statistics
import time

import numpy as np

from conftest import tiny_run
from portbench.lib import cell, stats


def test_rate_and_tail_over_every_step():
    times = [0.01] * 100
    base = cell.end_to_end(100, 8, sum(times), times, 0.1, 1.0)
    assert base["tracker_frames_per_s"] == 8 * 100 / sum(times)
    stalled = times[:90] + [0.05] * 10
    got = cell.end_to_end(100, 8, sum(stalled), stalled, 0.1, 1.0)
    assert got["tracker_frames_per_s"] < 0.8 * base["tracker_frames_per_s"]
    assert got["step_p95_ms"] == np.percentile(stalled, 95) * 1e3
    assert got["step_p95_ms"] > 4 * base["step_p95_ms"]


def test_spread_is_the_quartile_distance_over_the_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / med


class Stalling:
    """A fleet that sleeps `pause` seconds in every `every`-th step."""

    def __init__(self, fleet, pause=0.25, every=3):
        self.fleet, self.pause, self.every, self.n = fleet, pause, every, 0

    def initialize(self, *a):
        return self.fleet.initialize(*a)

    def corners(self, st):
        return self.fleet.corners(st)

    def update_multi(self, st, frames):
        self.n += 1
        if self.n % self.every == 0:
            time.sleep(self.pause)
        return self.fleet.update_multi(st, frames)


def test_a_planted_stall_moves_rate_and_tail():
    kw = dict(seconds=1.5, sizes={"cameras": 2, "check_trackers": 2})
    base = tiny_run("fclk_ssd_hom8.streams", **kw)["metrics"]
    slow = tiny_run("fclk_ssd_hom8.streams", fault=Stalling, **kw)["metrics"]
    assert (slow["tracker_frames_per_s"]["value"]
            < 0.7 * base["tracker_frames_per_s"]["value"])
    assert slow["step_p95_ms"]["value"] > base["step_p95_ms"]["value"] + 150


def test_mcd_over_the_first_steps_failed_over_all():
    """`mcd_px` is the mean over the window's first `mcd_steps` steps, so
    that a tracker that drifts is not read as less accurate for running
    more steps; `attempted` and `failed` count every step of the
    window."""
    from portbench.lib import check, generator
    gt = np.zeros((2, 2, 4, 2))                  # 2 frames, 2 cameras
    streams = generator.Streams(None, None, gt[0].astype(np.float32), gt)
    rec = check.Recorder(streams, np.array([0]), 20.0, mcd_steps=2)
    for k in range(1, 6):                        # step 1 is a warm-up
        err = 30.0 if k == 5 else float(k)
        rec.add(k, np.full((2, 4, 2), [err, 0.0]), timed=k > 1)
    rec.finish()
    assert rec.mcd_px == 2.5                     # steps 2 and 3
    assert rec.attempted == 8 and rec.failed == 2
    assert rec.timed == [2, 3, 4, 5]
