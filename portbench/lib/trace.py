"""What a `--trace 1` run reads: the benchmark's own host spans, a short
`torch.profiler` window, and the least times of the launches a roofline
metric names.

Per-layer metrics read a `TraceData` (`metrics/<name>.py: read(trace)`).
A metric may also name one function of the program by `WRAP = (module,
attribute)` and give `bound(result, *args, **kwargs) -> (ms, ...)`: in
a probe of a few steps after the profiled window, and outside it, the
harness wraps that function, and each call's least time lands in
`trace.bounds[<metric>]`."""
from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field

SPANS = ("handoff", "fleet_call", "readback")   # the benchmark's own spans
SPAN_PREFIX = "portbench."
NOT_KERNELS = ("Memcpy", "Memset")               # device ops, not kernels
TOP = 10                                         # breakdown entries


@dataclass
class TraceData:
    timed_steps: int = 0                 # steps of the host-clock window
    spans: dict = field(default_factory=dict)    # name -> [seconds]
    profiled_steps: int = 0
    window_us: tuple = (0.0, 0.0)        # the profiled window, profiler us
    device_ops: list = field(default_factory=list)   # (name, start, dur) us
    host_spans: list = field(default_factory=list)   # (name, start, end) us
    probe_steps: int = 0
    bounds: dict = field(default_factory=dict)   # metric -> [least ms]

    @property
    def kernels(self) -> list:
        return [e for e in self.device_ops
                if not e[0].startswith(NOT_KERNELS)]


def kernel_ms(trace: TraceData, patterns, inside: bool = True) -> tuple:
    """(device ms, launches) of the profiled window's kernels whose name
    holds one of `patterns` (`inside`), or none of them."""
    sel = [e for e in trace.kernels
           if any(p in e[0] for p in patterns) == inside]
    return sum(e[2] for e in sel) / 1e3, len(sel)


def merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(trace: TraceData) -> float:
    """Microseconds of the profiled window in which a device op ran."""
    lo, hi = trace.window_us
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged(
        (s, s + d) for _, s, d in trace.device_ops))


def idle_gaps(trace: TraceData) -> list:
    """[(what the host was doing, seconds)] of the device's idle gaps in
    the profiled window, longest first: the innermost benchmark span
    that covers a gap's start, or "outside"."""
    lo, hi = trace.window_us
    busy = merged((s, s + d) for _, s, d in trace.device_ops)
    edges, t = [], lo
    for a, b in busy:
        if a > t:
            edges.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        edges.append((t, hi))
    out = []
    for a, b in edges:
        if b <= a:
            continue
        cover = [s for s in trace.host_spans if s[1] <= a < s[2]]
        name = (min(cover, key=lambda s: s[2] - s[1])[0] if cover
                else "outside")
        out.append((name, (b - a) / 1e6))
    return sorted(out, key=lambda g: -g[1])


def breakdown(trace: TraceData) -> dict:
    """The device ops that took most time and the longest idle gaps."""
    tot = {}
    for name, _, d in trace.device_ops:
        tot[name] = tot.get(name, 0.0) + d / 1e6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [list(g) for g in idle_gaps(trace)[:TOP]]}


def from_profiler(prof, trace: TraceData) -> None:
    """Fill the profiled window's device ops, host spans and extent from
    a finished `torch.profiler.profile`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda:
            # a span's image on the device's timeline is no device op
            if not e.name.startswith(SPAN_PREFIX):
                trace.device_ops.append((e.name, float(tr.start),
                                         float(tr.end - tr.start)))
        elif e.name.startswith(SPAN_PREFIX):
            trace.host_spans.append((e.name[len(SPAN_PREFIX):],
                                     float(tr.start), float(tr.end)))
    steps = [s for s in trace.host_spans if s[0] == "step"]
    if steps:
        trace.window_us = (min(s[1] for s in steps),
                           max(max(s[2] for s in steps),
                               max((a + d for _, a, d in trace.device_ops),
                                   default=0.0)))


@contextlib.contextmanager
def wrapped(readers: dict, trace: TraceData):
    """Wrap the program function each reader of `readers` ({metric:
    module}) names by `WRAP`, so that each call adds its least time to
    `trace.bounds[metric]`; a name the program no longer has leaves the
    metric without bounds (its reader then reports nothing)."""
    undo = []
    try:
        for name, mod in readers.items():
            target = getattr(mod, "WRAP", None)
            if target is None:
                continue
            trace.bounds.setdefault(name, [])
            try:
                owner = importlib.import_module(target[0])
                orig = getattr(owner, target[1])
            except (ImportError, AttributeError):
                continue

            def call(*a, _orig=orig, _mod=mod, _name=name, **kw):
                out = _orig(*a, **kw)
                trace.bounds[_name].append(_mod.bound(out, *a, **kw)[0])
                return out

            setattr(owner, target[1], call)
            undo.append((owner, target[1], orig))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


def roofline_pct(trace: TraceData, metric: str, patterns):
    """Least time over device time of the launches of `patterns`, as a
    percentage: the probe's least ms per step over the profiled window's
    device ms per step; None where either side found nothing."""
    least = trace.bounds.get(metric)
    dev_ms, launches = kernel_ms(trace, patterns)
    if not least or not launches or not trace.probe_steps:
        return None
    return (sum(least) / trace.probe_steps) / (
        dev_ms / trace.profiled_steps) * 100.0
