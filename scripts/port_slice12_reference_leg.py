"""The JAX package's readings of the slice-12 GT legs that `chip_smoke.py`
runs on the card (`chip_smoke.slice12_family`), on the CPU.

    python scripts/port_slice12_reference_leg.py [fleet ...] [--whole]
    python scripts/port_slice12_reference_leg.py occlusion [--nudge N]

For each fleet (default all): the first 8 trackers' mean corner error per
frame and overall, and the limit `chip_smoke.gt_limit` derives from it;
where one of them is lost (beyond `chip_smoke.LOST_PX` on a frame), or
with `--whole`, the whole fleet's median per frame, its mean over the
frames, the trackers lost and those whose corners went non-finite, the
reading `chip_smoke._gt_leg_lost` holds the card to.

`occlusion`: TLD's occlusion leg as `chip_smoke._tld_occlusion` runs it
(its 16 boxes, trajectory and occluder), by lone JAX trackers (jitted)
and by the port's fleet on the CPU: which trackers went invalid while the
target was hidden, which were valid again after, the valid count per
frame, and the trackers on which the two packages' outcomes part; with
`--nudge N`, also the JAX trackers on the leg's frames 1 to N ulps up,
and the trackers whose re-acquisition flips against the first JAX run
(the spread `chip_smoke.TLD_OCC_REACQUIRED` takes).

Same scene, corners, configurations and 6-frame synthetic sequence (sigma
0.004, seed 3, drawn with the homography, `chip_smoke.SLICE12_GT_SSM`) as
`chip_smoke.py`; a fleet is tracked CHUNK trackers at a time by the JAX
package's vmapped `initialize` / `update` under `jit`.
"""
import argparse
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
from mtf_tpu.ssm import get_ssm  # noqa: E402
from mtf_tpu.utils import synth  # noqa: E402

CHUNK = {"tld": 8, "dft": 32}


def leg_errors(sm, frames, gt, corners, chunk):
    """(B, 5) mean corner error per tracker and frame (inf where not
    finite, as `chip_smoke._gt_leg_lost` takes it)."""
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
    e = np.concatenate(out)
    return np.where(np.isfinite(e), e, np.inf)


def _up(a, k):
    for _ in range(k):
        a = np.nextafter(a, np.float32(np.inf))
    return a


def _occlusion_valid(run, nudge=0):
    """(T, B) validity of the occlusion leg: `run` "jax" (lone jitted JAX
    trackers) or "port" (the port's fleet on the CPU); every frame moved
    `nudge` ulps up."""
    import torch
    from mtf_tpu_torch import create_tracker as tcreate
    scene = cs._tld_scene()
    c0, offs = cs.tld_occlusion_boxes()
    occ = np.random.default_rng(9)
    frames = [_up(cs.tld_occlusion_frame(scene, t, d, occ), nudge)
              for t, d in enumerate(cs.TLD_OCC_TRAJ)]
    scene = _up(scene, nudge)
    out = []
    if run == "jax":
        jt = create_tracker("tld", **cs.TLD_OCC_CFG)
        ji, ju = jax.jit(jt.initialize), jax.jit(jt.update)
        js = [ji(jnp.asarray(scene), jnp.asarray(c0 + o)) for o in offs]
        for f in frames:
            js = [ju(x, jnp.asarray(f)) for x in js]
            out.append([bool(x.valid) for x in js])
    else:
        tt = tcreate("tld", device="cpu", **cs.TLD_OCC_CFG)
        ts = tt.initialize(scene, c0[None] + offs)
        for f in frames:
            ts = tt.update(ts, torch.tensor(f))
            out.append(ts.valid.tolist())
    return np.array(out)


def occlusion(nudge=0):
    n = cs.B_SLICE12_ROUTING
    lo, hi = cs.TLD_OCC_HIDDEN
    runs = [("JAX package", _occlusion_valid("jax")),
            ("port", _occlusion_valid("port"))]
    runs += [(f"JAX package, frames {k} ulp up", _occlusion_valid("jax", k))
             for k in range(1, nudge + 1)]
    base = runs[0][1][hi:].any(0)
    for label, v in runs:
        back = v[hi:].any(0)
        print(f"{label}: went invalid while hidden "
              f"{int((~v[lo:hi].all(0)).sum())} of {n}, re-acquired "
              f"{int(back.sum())} of {n}: {np.flatnonzero(back).tolist()}; "
              f"valid per frame {v.sum(1).tolist()}; re-acquisition flips "
              f"against the first run on {int((back != base).sum())}: "
              f"{np.flatnonzero(back != base).tolist()}", flush=True)


def main():
    if sys.argv[1:2] == ["occlusion"]:
        ap = argparse.ArgumentParser()
        ap.add_argument("part")
        ap.add_argument("--nudge", type=int, default=0)
        return occlusion(ap.parse_args().nudge)
    ap = argparse.ArgumentParser()
    ap.add_argument("fleets", nargs="*")
    ap.add_argument("--whole", action="store_true")
    args = ap.parse_args()
    frame0 = cs._scene(0)
    fam = cs.slice12_family()
    for name in args.fleets or list(fam):
        key, am, ssm, b, cfg, _ = fam[name]
        t0 = time.perf_counter()
        crn = cs._corners(b)
        frames, gt = synth.synthetic_sequence(
            jnp.asarray(frame0), crn, get_ssm(cs.SLICE12_GT_SSM), n_frames=6,
            sigma_scale=0.004, seed=3)
        frames = np.asarray(frames)
        sm = create_tracker(key, am, ssm, **cfg)
        chunk = CHUNK.get(name, 64)
        e8 = leg_errors(sm, frames, gt, crn[:8], 8)
        per = e8.mean(0)
        print(f"{name}: first 8 trackers mean {float(per.mean()):.4f} px "
              f"(per frame {per.round(4).tolist()}), limit "
              f"{cs.gt_limit(float(per.mean())):.4f}; lost "
              f"{int((e8.max(1) > cs.LOST_PX).sum())} of 8", flush=True)
        if args.whole or (e8.max(1) > cs.LOST_PX).any():
            e = leg_errors(sm, frames, gt, crn, chunk)
            med = np.median(e, 0)
            lost = int((e.max(1) > cs.LOST_PX).sum())
            nf = int((~np.isfinite(e)).any(1).sum())
            print(f"{name}: whole fleet (B = {b}) median "
                  f"{float(med.mean()):.4f} px (per frame "
                  f"{med.round(4).tolist()}), {lost} of {b} lost, {nf} not "
                  f"finite; mean of the finite "
                  f"{float(e[np.isfinite(e).all(1)].mean()):.4f} px",
                  flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
