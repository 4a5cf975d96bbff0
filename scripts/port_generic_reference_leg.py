"""The JAX package's readings of the slice-8 GT legs that `chip_smoke.py`
runs on the card (the generic LK path: entry()'s configuration eslm/ncc
at 50x50, the spline50 row, iclk/ssd and its LM twin iclm on the
headline's shapes), on the CPU, for the first few trackers.

    python scripts/port_generic_reference_leg.py [n_trackers [name ...]]

Same scene, corners (each fleet's B), configuration
(`chip_smoke.generic_family`) and 6-frame synthetic sequence (sigma
0.004, seed 3, drawn with the fleet's GT SSM: the homography, also for
the spline) as `chip_smoke.py`; the sequence is rendered from all of a
fleet's corners, and the first `n_trackers` (default 8) are tracked on
the JAX package's default path for the CPU. `chip_smoke.py` takes each
fleet's reading over the whole fleet (`n_trackers` its B: 1024, 256,
1280): these fleets' trackers spread too widely for 8 to stand for it.
Prints, per fleet, the mean corner error per frame and overall, and the
limit `chip_smoke.py` derives from it (`chip_smoke.gt_limit`); then the
median corner error per frame and the trackers lost (beyond
`chip_smoke.LOST_PX` on some frame), which hold iclk_ssd's leg
(`chip_smoke.GENERIC_GT_LOST`).
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
from mtf_tpu.ssm import get_ssm  # noqa: E402
from mtf_tpu.utils import synth  # noqa: E402


def main(k: int = 8, names=()) -> None:
    fleets = dict(cs.generic_family())
    key, am, ssm, b, cfg, gt_ssm = fleets["iclk_ssd"]
    fleets["iclm_ssd"] = ("iclm", am, ssm, b, cfg, gt_ssm)
    for name, (key, am, ssm, b, cfg, gt_ssm) in fleets.items():
        if names and name not in names:
            continue
        corners = cs._corners(b)
        sm = create_tracker(key, am, ssm, **cfg)
        frames, gt = synth.synthetic_sequence(
            cs._scene(0), corners, get_ssm(gt_ssm), n_frames=6,
            sigma_scale=0.004, seed=3)
        fleet = TrackerFleet(sm)
        st = fleet.initialize(frames[0], corners[:k])
        e = []
        for t in range(1, len(frames)):
            st = fleet.update(st, frames[t])
            c = np.asarray(fleet.corners(st)).transpose(0, 2, 1)
            e.append(np.linalg.norm(c - gt[t][:k], axis=-1).mean(-1))
        e = np.stack(e, 1)                              # (k, 5)
        errs = e.mean(0).tolist()
        px = float(np.mean(errs))
        med = np.median(e, 0)
        lost = np.flatnonzero(e.max(1) > cs.LOST_PX)
        print(f"{name} ({key}/{am}/{ssm}) JAX CPU, {k} trackers: {px:.4f} px "
              f"mean (per frame {[round(x, 4) for x in errs]}); limit "
              f"{cs.gt_limit(px):.4f} px; median {float(med.mean()):.4f} px "
              f"(per frame {[round(float(x), 4) for x in med]}), {len(lost)} lost "
              f"(> {cs.LOST_PX} px on a frame): {lost.tolist()}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8, tuple(sys.argv[2:]))
