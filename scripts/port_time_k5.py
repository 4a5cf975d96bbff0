"""Time the grid-flow kernel (K5, linear taps; K5c with a cubic `interp`)
on the card at the shapes of real trackers, from whichever
`mtf_tpu_torch` comes first on `sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_time_k5.py [B] [interp | mf] [sweep]

Default B = 384 and interp `linear_mm`: the two grid-flow calls of one
update of the rklt fleet in `chip_smoke.py`'s configuration on its scene
moved by (3, 2) px (level 1: 16 points per patch, 8 iterations, 96-px
windows; level 0: 64 points, 1 iteration, 160-px windows). `mf` takes
the six calls of one Median Flow update instead (`chip_smoke.py`'s mf
fleet: 64 points, 20 iterations on 3 levels, forward then back). The
calls are recorded and replayed with the arguments as that tree passes
them, so two trees (a commit and its parent) can be timed in one call on
one card, in turns (parent, change, change, parent). `sweep` (a tree with
`grid_flow.layout`) also times every layout of each call: each power of
two of lanes per patch with the fewest points per lane that cover n,
against the disp of the default layout.

Prints one JSON line: per call the device time of one launch
(`chip_smoke._graph_ms`) and the time of one eager call (50 calls between CUDA
events, the host's launch time included), the sum of the device times, the
registers and spill bytes ptxas gave each grid-flow instantiation (by mangled
name), the package's path and the card.
"""
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

# the tree under test, its mtf_tpu_torch, comes from PYTHONPATH (this
# script's repository last); this repository's chip_smoke.py, by path (a
# tree has its own), gives every tree the same operands and timing
_REPO = Path(__file__).resolve().parents[1]
sys.path.append(str(_REPO))
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               _REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


def _registers(log: str) -> dict:
    """{mangled kernel name: [registers, spill store bytes, spill load
    bytes]} of the grid-flow kernels in an `nvcc -Xptxas -v` log."""
    out, name, spills = {}, None, [0, 0]
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "grid_flow_kernel" in name:
            out[name] = [int(m.group(1))] + spills
    return out


def _calls(b, key, dev):
    """The grid-flow calls (args, kwargs) of one update of the fleet."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.sm import grid as grid_mod
    frame = torch.as_tensor(cs._scene(0), device=dev)
    if key == "mf":
        sm_key, _, _, cfg, _ = cs.grid_family()["mf"]
    else:
        sm_key, cfg = "rklt", dict(cs.rklt_cfg(), interp=key)
    sm = create_tracker(sm_key, "ssd", "8", device=dev, **cfg)
    st = sm.initialize(frame, cs._corners(b))
    calls, real = [], grid_mod.grid_flow

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    grid_mod.grid_flow = record
    try:
        sm.update(st, torch.roll(frame, (3, 2), (0, 1)))
    finally:
        grid_mod.grid_flow = real
    return calls


def _layouts(gf, n):
    """Every (lanes, points per lane) the kernel takes for n points, the
    fewest points per lane for each lane count, no lane idle."""
    out = []
    for lanes in (1, 2, 4, 8, 16, 32):
        k = next((k for k in gf.POINTS_PER_LANE if lanes * k >= n), None)
        if k is not None and (lanes == 1 or lanes // 2 * k < n):
            out.append((lanes, k))
    return out


def main(b: int = 384, key: str = "linear_mm", sweep: str = "") -> int:
    if not torch.cuda.is_available():
        print("port_time_k5: needs a CUDA device", file=sys.stderr)
        return 1
    import mtf_tpu_torch
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    calls = _calls(b, key, dev)
    out = {}
    for i, (args, kw) in enumerate(calls):
        n, n_iters = args[4], args[5]
        label = (f"call{i}" if key == "mf"
                 else ("level1" if n_iters > 1 else "level0"))

        def call():
            return gf.grid_flow(*args, **kw)

        out[label] = {"ms": cs._graph_ms(torch, call),
                      "ms_eager": cs._time_ms(torch, call, 50), "n": n,
                      "iters": n_iters, "window": args[0].shape[-1]}
        if sweep and hasattr(gf, "layout"):
            want = gf.grid_flow(*args, **kw)
            zncc = kw.get("zncc", args[6] if len(args) > 6 else True)
            kind = kw.get("kind", args[7] if len(args) > 7 else "linear")
            out[label]["layout"] = list(gf.layout(n, n_iters))
            out[label]["sweep"] = {}
            for lanes, k in _layouts(gf, n):
                def run():
                    return gf.launch(*args[:6], zncc, kind, lanes, k)
                diff = float((run() - want).abs().max())
                out[label]["sweep"][f"{lanes}x{k}"] = {
                    "ms": cs._graph_ms(torch, run), "diff": diff}
    print(json.dumps({"k5": out, "ms_sum": sum(r["ms"] for r in out.values()),
                      "B": b, "key": key,
                      "registers": _registers(_build.load("grid_flow").log),
                      "package": str(Path(mtf_tpu_torch.__file__).parent),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:4]))
