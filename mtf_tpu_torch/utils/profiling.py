"""Profiling: event-taxonomy timers + device trace hooks (port of
`mtf_tpu/utils/profiling.py`).

Re-designs the reference's macro profiler (`Macros/common.h:73-114`:
`init_timer/record_event` interleaved through SM hot loops, writing
per-event wall times to `log/mtf_<sm>_times.txt`):

  * `Profiler` — host-side event timing with the same label taxonomy and
    artifact format (per-label mean/total written to log/); a section
    given `sync` waits for the devices of its tensors, so it times the
    device work, not its dispatch;
  * `trace(...)` — context manager around `torch.profiler.profile` that
    writes a Chrome trace of the host ops and, on the card, the kernels
    (stages show up as `annotate` ranges);
  * `annotate(label)` — `torch.profiler.record_function`, a named range
    for SM stages.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils import _pytree as pytree

annotate = torch.profiler.record_function


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree` (a tensor
    or any tree of them); tensors on the CPU need no wait."""
    devices = {x.device for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class Profiler:
    """Host-side event profiler (init_timer/record_event analog)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: dict[str, list[float]] = {}
        self._t0 = time.perf_counter()

    def init_timer(self):
        self._t0 = time.perf_counter()

    def record_event(self, label: str):
        if not self.enabled:
            return
        t = time.perf_counter()
        self.events.setdefault(label, []).append(t - self._t0)
        self._t0 = t

    @contextlib.contextmanager
    def section(self, label: str, sync=None):
        """Timed block; pass `sync=<tensors>` to include their device time
        (a synchronize on their devices) rather than dispatch time."""
        if sync is not None:
            synchronize(sync)
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        self.events.setdefault(label, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {k: {"n": len(v), "total_s": sum(v),
                    "mean_ms": 1e3 * sum(v) / max(len(v), 1)}
                for k, v in self.events.items()}

    def write(self, path: str = "log/times.txt"):
        """Reference artifact format: one line per event label."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for k, s in sorted(self.summary().items()):
                f.write(f"{k} n={s['n']} total={s['total_s']:.6f}s "
                        f"mean={s['mean_ms']:.3f}ms\n")
        return path


@contextlib.contextmanager
def trace(log_dir: str = "log/torch_trace"):
    """Device-timeline trace: `log_dir/trace.json` (open in
    chrome://tracing or Perfetto). Yields `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
