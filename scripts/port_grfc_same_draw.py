"""grfc's GT leg (`chip_smoke.grid_family()["grfc"]`, B = 384, the
6-frame synthetic sequence of sigma 0.004, seed 3) through the JAX package
and through the port's plain path, both on the CPU, with the port's grid
handed the JAX package's RANSAC index draw, so that the two packages
differ only by their arithmetic.

    python scripts/port_grfc_same_draw.py [threshold_px]

Prints, per package, the trackers that end the leg more than
`threshold_px` (default 1.0) from the ground truth, each one's error, the
largest per-tracker difference of the two packages' errors per frame, and
the fleet's mean error per frame.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from mtf_tpu import create_tracker as jcreate  # noqa: E402
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet  # noqa: E402
from mtf_tpu.utils import synth as jsynth  # noqa: E402
from mtf_tpu_torch import create_tracker as tcreate  # noqa: E402
from test_torch_grid import jax_fit_indices, use_indices  # noqa: E402


def _errors(fleet_step, corners_of, frames, gt):
    errs = []
    for t in range(1, len(frames)):
        fleet_step(frames[t])
        c = corners_of().transpose(0, 2, 1)
        errs.append(np.linalg.norm(c - gt[t], axis=-1).mean(-1))
    return np.stack(errs)


def main(threshold: float = 1.0) -> None:
    key, am, b, cfg, _ = cs.grid_family()["grfc"]
    corners = cs._corners(b)
    jsm = jcreate(key, am, "8", **cfg)
    frames, gt = jsynth.synthetic_sequence(cs._scene(0), corners, jsm.ssm,
                                           n_frames=6, sigma_scale=0.004,
                                           seed=3)
    frames = np.asarray(frames)
    fl = JFleet(jsm)
    box = {"j": fl.initialize(frames[0], corners)}

    def jstep(f):
        box["j"] = fl.update(box["j"], f)

    jerr = _errors(jstep, lambda: np.asarray(fl.corners(box["j"])), frames,
                   gt)
    tsm = tcreate(key, am, "8", device="cpu", **cfg)
    use_indices(tsm.members[0], jax_fit_indices(len(frames) - 1))
    box["t"] = tsm.initialize(frames[0], corners)

    def tstep(f):
        box["t"] = tsm.update(box["t"], f)

    terr = _errors(tstep, lambda: tsm.corners(box["t"]).numpy(), frames, gt)
    for name, e in (("JAX", jerr), ("port", terr)):
        lost = np.nonzero(e[-1] > threshold)[0]
        print(f"{name}: {len(lost)} trackers end over {threshold} px: "
              f"{dict(zip(lost.tolist(), np.round(e[-1][lost], 3).tolist()))}"
              f"; fleet mean per frame {np.round(e.mean(-1), 4).tolist()}")
    print("largest per-tracker difference per frame:",
          np.round(np.abs(jerr - terr).max(-1), 4).tolist(), "at trackers",
          np.abs(jerr - terr).argmax(-1).tolist())


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 1.0)
