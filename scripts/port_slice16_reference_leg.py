"""The JAX package's reading of the slice-16 GT leg that `chip_smoke.py`
runs on the card: the sub-tracker grid with no crop (`chip_smoke.
slice16_family()["subgrid_nocrop"]`: 100 fclk/ssd/2 sub-trackers per
tracker on the homography, each reading the whole 480x640 frame), on the
CPU, for the first few trackers.

    python scripts/port_slice16_reference_leg.py [n_trackers]

Same scene, corners (B = chip_smoke.B_RKLT), configuration and 6-frame
synthetic sequence (sigma 0.004, seed 3, drawn with the homography over
all B trackers' corners) as `chip_smoke.py`; the first `n_trackers`
(default 8) are tracked on the JAX package's default path for the CPU,
with its own RANSAC draws. Prints the mean corner error per frame and
overall, and the limit `chip_smoke.py` derives from it
(`chip_smoke.gt_limit`).
"""
import sys
import time
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
    t0 = time.perf_counter()
    name = "subgrid_nocrop"
    key, am, ssm, b, cfg, _ = cs.slice16_family()[name]
    corners = cs._corners(b)
    sm = create_tracker(key, am, ssm, **cfg)
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
    print(f"{name} ({key}/{am}/{ssm}) JAX CPU, {k} trackers: {px:.4f} px "
          f"mean (per frame {[round(e, 4) for e in errs]}); limit "
          f"{cs.gt_limit(px):.4f} px; {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
