"""Where the time of one fleet update of the PyTorch/CUDA port goes, on
the card.

    python scripts/port_profile_fleet.py [sm am B] ...

Each argument triple (default: "fclk ssd 1280", "esm ncc 1024",
"eslm ncc 1024", "rklt ssd 384", "fclk mcssd 512",
"fclk@cubic_mm ssd 1280", slice 5's "rklt_cubic ssd 384",
"mf ssd 384", "grfc ssd 384", "prl ssd 1024" and "pyr ssd 1280", and
slice 6's "fclk/6 ssd 1280", "rklt/6 ssd 384" and "subgrid ssd 384") is
one fleet in `chip_smoke.py`'s configuration for its key (`sm@interp`
picks the taps, `sm/ssm` any SSM key, the homography "8" by default; a
name of `chip_smoke.grid_family` or `chip_smoke.ssm_family` takes that
fleet's key, SSM and configuration), on its scene (the 3-channel one for
the multi-channel AM keys) and corners. Per fleet: 3 warm-up updates,
the wall time of 20 updates by the host clock (ending in a synchronize),
then 5 updates under `torch.profiler` (CPU and CUDA): the device time of
all kernels per update, the busy share (that time over the unprofiled
update's wall time, and over the profiled one, which the profiler's own
host cost inflates), the kernel launches per update, and the kernels
that take most device time. Prints one JSON line per fleet, and the
profiler table to standard error.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtf_tpu_torch import create_tracker  # noqa: E402
from mtf_tpu_torch.parallel import TrackerFleet  # noqa: E402

PROFILED = 5
TIMED = 20


def profile(key: str, am: str, b: int, card: str) -> dict:
    dev = torch.device("cuda", 0)
    name = key
    key, _, ssm = key.partition("/")
    key, _, interp = key.partition("@")
    ssm = ssm or "8"
    cfg = cs.cfg_of(key, interp or "linear_mm")
    family = cs.grid_family()
    if key in family:
        key, _, _, cfg, _ = family[key]
    ssm_family = cs.ssm_family()
    if key in ssm_family:
        key, _, ssm, _, cfg, _, _ = ssm_family[key]
    mc = am.startswith("mc") or am.endswith("3")
    frame = torch.as_tensor(cs._scene3(0) if mc else cs._scene(0), device=dev)
    fleet = TrackerFleet(create_tracker(key, am, ssm, device=dev, **cfg),
                         donate=True)
    st = fleet.initialize(frame, cs._corners(b))
    for _ in range(3):
        st = fleet.update(st, frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        st = fleet.update(st, frame)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / TIMED * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            st = fleet.update(st, frame)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25), file=sys.stderr)
    return {
        "fleet": f"{name}/{am}", "B": b,
        "card": card,
        "update_ms": update_ms, "frames_per_s": b / update_ms * 1e3,
        "profiled_update_ms": wall_ms / PROFILED,
        "device_ms_per_update": busy_ms / PROFILED,
        "busy_share": busy_ms / PROFILED / update_ms,
        "busy_share_profiled": busy_ms / wall_ms,
        "kernel_launches_per_update": sum(e.count for e in kernels)
        / PROFILED,
        "top_kernels_ms_per_update": {
            e.key[:60]: e.self_device_time_total / 1e3 / PROFILED
            for e in top},
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("port_profile_fleet: needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    triples = ([argv[i:i + 3] for i in range(0, len(argv), 3)] if argv
               else [["fclk", "ssd", "1280"], ["esm", "ncc", "1024"],
                     ["eslm", "ncc", "1024"], ["rklt", "ssd", "384"],
                     ["fclk", "mcssd", "512"],
                     ["fclk@cubic_mm", "ssd", "1280"],
                     ["rklt_cubic", "ssd", "384"], ["mf", "ssd", "384"],
                     ["grfc", "ssd", "384"], ["prl", "ssd", "1024"],
                     ["pyr", "ssd", "1280"], ["fclk/6", "ssd", "1280"],
                     ["rklt/6", "ssd", "384"], ["subgrid", "ssd", "384"]])
    for key, am, b in triples:
        print(json.dumps(profile(key, am, int(b), card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
