"""One run of one cell: set-up, warm-up, the measured window, the traced
window (with `trace`), the comparison with the plain reference, and the
result line's object.

The step is the cell's whole closed loop: hand the fleet the step's
frames (a view of the frame pool), one `TrackerFleet` call, and every
tracker's corners read back to the host; a step's time runs from the
hand-off to the corners on the host."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import check, generator, guard, registry, stats
from . import trace as tr


class Forbidden(RuntimeError):
    """A module of the JAX package or JAX was loaded."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def end_to_end(steps: int, cameras: int, window_s: float, times, mcd: float,
               setup_s: float) -> dict:
    """The end-to-end metrics by name."""
    return {"tracker_frames_per_s": stats.rate(cameras * steps, window_s),
            "step_p95_ms": stats.p95(times) * 1e3,
            "mcd_px": mcd, "setup_s": setup_s}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: dict | None = None, root=registry.ROOT,
             sizes: dict | None = None, options: dict | None = None,
             fault=None, numbers_out: dict | None = None) -> dict:
    """Run cell `name` once and return the result line's object. `sizes`
    and `options` override the cell's sizes and the tracker's options (the
    tests' small runs, the control); `fault` wraps the fleet (the tests'
    and the control's planted faults); `numbers_out` receives every number
    of the comparison, those the cell does not compare too."""
    import torch
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import TrackerFleet

    bench = bench or registry.benchmark()
    wl = registry.workload(bench, name)
    cfg = registry.config(wl["config"], root)
    mix = registry.traffic(wl["traffic"], root)
    size = {**registry.cell(name, root), **(sizes or {})}
    tk = cfg["tracker"]
    opts = {**tk["options"], **(options or {})}
    b = int(size["cameras"])
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(1, device=device)     # the allocator's stats need it
        torch.cuda.reset_peak_memory_stats(device)
    streams = generator.make(mix, b, cfg["frame"]["height"],
                             cfg["frame"]["width"], seed, device)
    fleet = TrackerFleet(create_tracker(tk["sm"], tk["am"], tk["ssm"],
                                        device=device, **opts), donate=True)
    if fault is not None:
        fleet = fault(fleet)
    step_fn = fleet.update_multi
    rows = np.sort(generator.rng(seed, 3).choice(
        b, min(int(size["check_trackers"]), b), replace=False))
    rec = check.Recorder(streams, rows, float(mix["fail_mcd_px"]),
                         int(size["mcd_steps"]))
    st = fleet.initialize(streams.init_frame, streams.corners0)

    def step(k, st):
        frames = generator.frames_at(streams, k)
        st = step_fn(st, frames)
        return st, fleet.corners(st).cpu().numpy().transpose(0, 2, 1)

    k = 0
    for _ in range(int(size["warmup_steps"])):
        k += 1
        st, c = step(k, st)
        rec.add(k, c, False)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    # the measured window
    spans = {s: [] for s in tr.SPANS}
    times = []
    w0 = time.perf_counter()
    while True:
        k += 1
        t0 = time.perf_counter()
        frames = generator.frames_at(streams, k)
        t1 = time.perf_counter()
        st = step_fn(st, frames)
        t2 = time.perf_counter()
        c = fleet.corners(st).cpu().numpy().transpose(0, 2, 1)
        t3 = time.perf_counter()
        times.append(t3 - t0)
        for s, d in zip(tr.SPANS, (t1 - t0, t2 - t1, t3 - t2)):
            spans[s].append(d)
        rec.add(k, c, True)
        if t3 - w0 >= seconds:
            break
    window_s = t3 - w0
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    log(f"steps {len(times)} in {window_s:.4f} s, B = {b}; mcd_px over "
        f"the first {min(len(times), int(size['mcd_steps']))}")

    td = None
    if trace:
        td = tr.TraceData(timed_steps=len(times), spans=spans)
        readers = {m["name"]: registry.metric(m["name"], root)
                   for m in registry.metrics_of(bench, name, "per_layer")}
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        rf = torch.profiler.record_function
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(int(size["profiled_steps"])):
                k += 1
                with rf(tr.SPAN_PREFIX + "step"):
                    with rf(tr.SPAN_PREFIX + "handoff"):
                        frames = generator.frames_at(streams, k)
                    with rf(tr.SPAN_PREFIX + "fleet_call"):
                        st = step_fn(st, frames)
                    with rf(tr.SPAN_PREFIX + "readback"):
                        c = fleet.corners(st).cpu().numpy().transpose(0, 2, 1)
                rec.add(k, c, False)
            _sync(torch, device)
        tr.from_profiler(prof, td)
        td.profiled_steps = int(size["profiled_steps"])
        del prof
        with tr.wrapped(readers, td):
            for _ in range(int(size["probe_steps"])):
                k += 1
                st, c = step(k, st)
                rec.add(k, c, False)
            _sync(torch, device)
        td.probe_steps = int(size["probe_steps"])
        layer = {n: r.read(td) for n, r in readers.items()}

    # the program's state goes before the reference runs
    del st, fleet, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec.finish()
    ref = registry.reference(wl["config"], root)
    c0 = time.perf_counter()
    with check.plain_precision():
        numbers = check.compare(ref, cfg, streams, rec, seed,
                                int(size["check_steps_per_tracker"]))
    log(f"reference: {time.perf_counter() - c0:.3f} s over "
        f"{len(rows)} trackers")
    limits = size["limits"]
    if numbers_out is not None:
        numbers_out.update(numbers)
    correct = bool(rec.attempted > 0 and all(
        numbers[n] <= limits[n] for n in limits))

    if trace:
        metrics = {m["name"]: {"value": layer[m["name"]], "unit": m["unit"]}
                   for m in registry.metrics_of(bench, name, "per_layer")
                   if layer.get(m["name"]) is not None}
    else:
        e2e = end_to_end(len(times), b, window_s, times, rec.mcd_px,
                         setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in registry.metrics_of(bench, name, "end_to_end")}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace:
        lo, hi = td.window_us
        dev["busy_s"] = tr.busy_us(td) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = tr.breakdown(td)
    out["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                     for n in limits}
    for n in sorted(set(numbers) - set(limits)):
        log(f"{n} {numbers[n]!r} (not compared)")
    for n in limits:
        log(f"{n} {numbers[n]!r} limit {limits[n]!r}")
    # last, over everything the run loaded, the reference included
    bad = guard.forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        raise Forbidden(f"forbidden modules loaded: {bad}")
    return out
