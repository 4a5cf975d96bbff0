"""The JAX package's reading of the rklt/ssd GT leg that `chip_smoke.py`
runs on the card, on the CPU, for the first few trackers.

    python scripts/port_rklt_reference_leg.py [n_trackers]

Same scene, corners (B = 384), configuration (the rklt row of
`bench_extra.py`) and 6-frame synthetic sequence (sigma 0.004, seed 3)
as `chip_smoke.py`'s rklt phase; the sequence is rendered from all of
its trackers' corners (the global warp depends on them), and the first
`n_trackers` (default 8) are tracked on the JAX package's default path
for the CPU. Prints the mean corner error per frame and overall, and the
limit `chip_smoke.py` derives from it: twice the reading above 0.1 px,
else 0.2 px.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtf_tpu import create_tracker  # noqa: E402
from mtf_tpu.parallel.fleet import TrackerFleet  # noqa: E402
from mtf_tpu.utils import synth  # noqa: E402


def main(k: int = 8) -> None:
    corners = cs._corners(cs.B_RKLT)
    sm = create_tracker("rklt", "ssd", "8", **cs.rklt_cfg())
    frames, gt = synth.synthetic_sequence(cs._scene(0), corners, sm.ssm,
                                          n_frames=6, sigma_scale=0.004,
                                          seed=3)
    fleet = TrackerFleet(sm)
    st = fleet.initialize(frames[0], corners[:k])
    errs = []
    for t in range(1, len(frames)):
        st = fleet.update(st, frames[t])
        c = np.asarray(fleet.corners(st)).transpose(0, 2, 1)
        errs.append(float(np.linalg.norm(c - gt[t][:k], axis=-1).mean()))
    px = float(np.mean(errs))
    print(f"rklt/ssd JAX CPU, {k} trackers: {px:.4f} px mean "
          f"(per frame {[round(e, 4) for e in errs]}); limit "
          f"{2 * px if px > 0.1 else 0.2:.4f} px")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
