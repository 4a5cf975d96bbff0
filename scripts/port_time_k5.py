"""Time the grid-flow kernel (K5, linear taps; K5c with a cubic `interp`)
on the card at both levels of real rklt trackers, from whichever
`mtf_tpu_torch` comes first on `sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_time_k5.py [B] [interp]

Default B = 384 (the rklt fleet) and interp `linear_mm`. The operands are
the two grid-flow calls of one update of the rklt fleet in
`chip_smoke.py`'s configuration on its scene moved by (3, 2) px (level 1:
16 points per patch, 8 iterations, 96-px windows; level 0: 64 points, 1
iteration, 160-px windows), recorded and replayed with the arguments as
that tree passes them, so two trees (a commit and its parent) can be
timed in one call on one card, in turns (parent, change, change,
parent). Prints one JSON line: per level the median of 5 CUDA-event
timings of 200 launches each, the registers and spill bytes ptxas gave
each grid-flow instantiation (by mangled name), the package's path and
the card.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

# this script's repository last: the tree under test comes from PYTHONPATH
sys.path.append(str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


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


def main(b: int = 384, interp: str = "linear_mm") -> int:
    if not torch.cuda.is_available():
        print("port_time_k5: needs a CUDA device", file=sys.stderr)
        return 1
    import mtf_tpu_torch
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    from mtf_tpu_torch.sm import grid as grid_mod
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frame = torch.as_tensor(cs._scene(0), device=dev)
    sm = create_tracker("rklt", "ssd", "8", device=dev,
                        **dict(cs.rklt_cfg(), interp=interp))
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
    out = {}
    for args, kw in calls:
        times = sorted(cs._time_ms(torch, lambda: gf.grid_flow(*args, **kw),
                                   200) for _ in range(5))
        out["level1" if args[5] > 1 else "level0"] = {
            "ms": times[2], "ms_all": times, "n": args[4],
            "iters": args[5]}
    print(json.dumps({"k5": out, "B": b, "interp": interp,
                      "registers": _registers(_build.load("grid_flow").log),
                      "package": str(Path(mtf_tpu_torch.__file__).parent),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:3]))
