"""The JAX package's readings of the slice-9 GT legs that `chip_smoke.py`
runs on the card (the pf500 and nn1k rows, `chip_smoke.stochastic_family`),
on the CPU, over the whole fleet, at each of `chip_smoke.GT_SEEDS`.

    python scripts/port_stochastic_reference_leg.py [chunk [name ...]]

Same scene, corners (each row's B), configuration and 6-frame synthetic
sequence (sigma 0.004, seed 3, drawn with the row's homography) as
`chip_smoke.py`. The `seed` option seeds PF's and NN's draws; every
tracker of a JAX fleet draws from the same key, so the fleet is tracked
`chunk` trackers at a time (default 8; one compile per row and seed) with
the same result as in one batch. Prints, per row and seed, the mean
corner error per frame and overall, the median corner error per frame
and the trackers lost (beyond `chip_smoke.LOST_PX` on some frame); then,
per row, the worst seed's reading and the limit `chip_smoke.py` derives
from it (`chip_smoke.gt_limit`).
"""
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtf_tpu import create_tracker  # noqa: E402
from mtf_tpu.utils import synth  # noqa: E402


def leg_errors(sm, frames, gt, corners, chunk):
    """(B, 5) mean corner error per tracker and frame."""
    init = jax.jit(jax.vmap(sm.initialize, in_axes=(None, 0)))
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    crn = jax.jit(jax.vmap(sm.corners))
    out = []
    for i in range(0, len(corners), chunk):
        st = init(jnp.asarray(frames[0]), jnp.asarray(corners[i:i + chunk]))
        e = []
        for t in range(1, len(frames)):
            st = upd(st, jnp.asarray(frames[t]))
            c = np.asarray(crn(st)).transpose(0, 2, 1)
            e.append(np.linalg.norm(c - gt[t][i:i + chunk], axis=-1).mean(-1))
        out.append(np.stack(e, 1))
    return np.concatenate(out)


def main(chunk: int = 8, names=()) -> None:
    for name, (key, am, ssm, b, cfg) in cs.stochastic_family().items():
        if names and name not in names:
            continue
        corners = cs._corners(b)
        worst = 0.0
        for seed in cs.GT_SEEDS:
            t0 = time.perf_counter()
            sm = create_tracker(key, am, ssm, seed=seed, **cfg)
            frames, gt = synth.synthetic_sequence(
                cs._scene(0), corners, sm.ssm, n_frames=6, sigma_scale=0.004,
                seed=3)
            e = leg_errors(sm, np.asarray(frames), gt, corners, chunk)
            errs = e.mean(0).tolist()
            px = float(np.mean(errs))
            worst = max(worst, px)
            med = np.median(e, 0)
            lost = np.flatnonzero(e.max(1) > cs.LOST_PX)
            print(f"{name} ({key}/{am}/{ssm}) seed {seed}, JAX CPU, {b} "
                  f"trackers: {px:.4f} px mean (per frame "
                  f"{[round(x, 4) for x in errs]}); median "
                  f"{float(med.mean()):.4f} px (per frame "
                  f"{[round(float(x), 4) for x in med]}), {len(lost)} lost "
                  f"(> {cs.LOST_PX} px on a frame): {lost.tolist()} "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        print(f"{name}: worst seed {worst:.4f} px; limit "
              f"{cs.gt_limit(worst):.4f} px", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8, tuple(sys.argv[2:]))
