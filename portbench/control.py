"""The readings that set the correctness limits: the control and the
planted faults, on the card, at a cell's own size. The benchmark's own
runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--sound] [--faults]

For each seed, in one process: the control (the program's own bfloat16
path, `interp_bf16=True`, the nearest precision below the float32 that
the configuration states, compared with the float32 reference), with
`--sound` a sound run, and with `--faults` each fault of
`lib/faults.py`. One JSON line per run on standard output: the seed,
the run, `correct`, each compared number, and every number of the
comparison (the gaps' 99th percentiles and medians too)."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import cell, faults
    if not torch.cuda.is_available():
        cell.log("control: needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    runs = ([("sound", {}, None)] if args.sound else []) + [
        ("control_bf16", {"interp_bf16": True}, None)]
    if args.faults:
        runs += [(f"fault_{k}", {}, faults.planting(k)) for k in faults.KINDS]
    for seed in (int(s) for s in args.seeds.split(",")):
        for label, opts, fault in runs:
            numbers = {}
            out = cell.run_cell(args.workload, seed, args.seconds, False, dev,
                                time.perf_counter(), options=opts,
                                fault=fault, numbers_out=numbers)
            print(json.dumps({
                "seed": seed, "run": label, "correct": out["correct"],
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "numbers": numbers,
                "mcd_px": out["metrics"]["mcd_px"]["value"],
                "failed": out["failed"], "attempted": out["attempted"]}),
                flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
