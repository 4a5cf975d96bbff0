"""The JAX package's readings of the two multi-channel GT legs that
`chip_smoke.py` runs on the card (fclk/mcssd and fclm/mcssd), on the CPU,
for the first few trackers.

    python scripts/port_mc_reference_leg.py [n_trackers]

Same 3-channel scene (`chip_smoke._scene3`), corners (B = 512),
configuration and 6-frame synthetic sequence (sigma 0.004, seed 3) as
`chip_smoke.py`'s mcssd phase; the sequence is rendered from all of its
trackers' corners (the global warp depends on them), and the first
`n_trackers` (default 8) are tracked on the JAX package's default path
for the CPU. Prints, per key, the mean corner error per frame and
overall, and the limit `chip_smoke.py` derives from it: twice the reading
above 0.1 px, else 0.2 px.
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


def leg(key: str, frames, gt, corners, k: int) -> None:
    fleet = TrackerFleet(create_tracker(key, "mcssd", "8", **cs.slice_cfg()))
    st = fleet.initialize(frames[0], corners[:k])
    errs = []
    for t in range(1, len(frames)):
        st = fleet.update(st, frames[t])
        c = np.asarray(fleet.corners(st)).transpose(0, 2, 1)
        errs.append(float(np.linalg.norm(c - gt[t][:k], axis=-1).mean()))
    px = float(np.mean(errs))
    print(f"{key}/mcssd JAX CPU, {k} trackers: {px:.4f} px mean "
          f"(per frame {[round(e, 4) for e in errs]}); limit "
          f"{2 * px if px > 0.1 else 0.2:.4f} px", flush=True)


def main(k: int = 8) -> None:
    corners = cs._corners(cs.B_MC)
    ssm = create_tracker("fclk", "mcssd", "8", **cs.slice_cfg()).ssm
    frames, gt = synth.synthetic_sequence(cs._scene3(0), corners, ssm,
                                          n_frames=6, sigma_scale=0.004,
                                          seed=3)
    for key in ("fclk", "fclm"):
        leg(key, frames, gt, corners, k)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
