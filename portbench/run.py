"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (`mtf_tpu_torch`),
on a machine with as many CUDA devices as the cell asks for. Prints the
count of steps, then each number the correctness check compared beside
its limit, on standard error; the last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` `breakdown`, and `checks` last). Exits non-zero with no
result line where there is no CUDA device or too few, where the program
cannot be imported, and where a module of JAX or of the JAX package
(`mtf_tpu`) was loaded."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def process_start() -> float:
    """`time.perf_counter()`'s reading at this process's start (from
    /proc/self/stat; the module's first line where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 60 else T0
    except (OSError, ValueError, IndexError):
        return T0


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import cell, registry
    bench = registry.benchmark()
    chips = registry.workload(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        cell.log(f"portbench: {args.workload} needs {chips} CUDA device(s); "
                 f"found {torch.cuda.device_count()}")
        return 2
    try:
        out = cell.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            t_start, bench)
    except cell.Forbidden:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
