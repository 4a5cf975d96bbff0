"""The JAX package's readings of the slice-5 GT legs that `chip_smoke.py`
runs on the card (rklt at `cubic_mm` and `cubic_bspl_mm`, Median Flow,
the rigid grid at `cubic_mm`, grfc, prl and pyr), on the CPU, for the
first few trackers.

    python scripts/port_grid_family_reference_leg.py [n_trackers [name ...]]

Same scene, corners (each fleet's B), configuration
(`chip_smoke.grid_family`) and 6-frame synthetic sequence (sigma 0.004,
seed 3) as `chip_smoke.py`; the sequence is rendered from all of a
fleet's corners (the global warp depends on them), and the first
`n_trackers` (default 8) are tracked on the JAX package's default path
for the CPU. The grid's RANSAC draws are the JAX package's own. Prints,
per fleet, the mean corner error per frame and overall, and the limit
`chip_smoke.py` derives from it (`chip_smoke.gt_limit`).
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


def main(k: int = 8, names=()) -> None:
    for name, (key, am, b, cfg, _) in cs.grid_family().items():
        if names and name not in names:
            continue
        corners = cs._corners(b)
        sm = create_tracker(key, am, "8", **cfg)
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
        print(f"{name} ({key}/{am}) JAX CPU, {k} trackers: {px:.4f} px mean "
              f"(per frame {[round(e, 4) for e in errs]}); limit "
              f"{cs.gt_limit(px):.4f} px", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8, tuple(sys.argv[2:]))
