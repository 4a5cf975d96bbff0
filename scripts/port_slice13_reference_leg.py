"""The JAX package's readings of the slice-13 run_mtf legs that
`chip_smoke.py` runs on the card (`chip_smoke.slice13_legs`), on the CPU.

    python scripts/port_slice13_reference_leg.py [--keep DIR]

Records the slice-13 sequence with `chip_smoke.slice13_sequence` (the
port's `synthetic_sequence` on the CPU, 60 frames of 480x640 written as
8-bit PNGs, and the MTF GT file), then runs `mtf_tpu.apps.run_mtf` on it
in-process for fclk/ssd, esm/ncc and rklt/ssd at the bench configuration
(`chip_smoke.slice13_pairs`), each with `--reinit_on_failure`, and prints
each leg's summary line and the (avg_mcd, failures) pair that
`chip_smoke.SLICE13_JAX_READING` holds. `--keep DIR` records the
sequence under DIR and keeps it.
"""
import argparse
import contextlib
import io
import re
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtf_tpu.apps import run_mtf  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--keep", default=None)
    args = p.parse_args()
    root = args.keep or tempfile.mkdtemp()
    t0 = time.perf_counter()
    seq, gt_path, _ = cs.slice13_sequence(root, "cpu")
    print(f"recorded {seq} in {time.perf_counter() - t0:.1f} s")
    readings = {}
    for name, (pairs, _) in cs.slice13_legs().items():
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, avg = run_mtf.main(["--seq", seq, "--gt", gt_path,
                                   "--reinit_on_failure", "--platform",
                                   "cpu", "--out_dir",
                                   str(Path(root) / "log")] + pairs)
        summary = buf.getvalue().strip().splitlines()[-1]
        failures = int(re.search(r"failures=(\d+)", summary).group(1))
        readings[name] = (avg, failures)
        print(f"{name}: {summary} ({time.perf_counter() - t0:.1f} s)")
    print("SLICE13_JAX_READING = " + repr(readings))
    return readings


if __name__ == "__main__":
    main()
