"""The JAX package's readings of the slice-15 GT legs that `chip_smoke.py`
runs on the card, on the CPU.

    python scripts/port_slice15_reference_leg.py [name ...]

Per-tracker legs (`chip_smoke.slice15_family`): the JAX fleet's
`update_multi` (`jax.vmap(sm.update, in_axes=(0, 0))`, one frame per
tracker) over the first `chip_smoke.SLICE15_GT_TRACKERS` trackers of the
fleet's corners, tracker b on sequence b (`chip_smoke.py`'s tracker b
reads sequence b mod `SLICE15_SEQS`; sequence k is the 6-frame GT leg at
seed `SLICE15_SEQ_SEEDS[k]`, drawn over all B trackers' corners), at each
of the fleet's seeds (its draws). Every JAX pfrk update raises (ROADMAP
Queue 3, item 13), so pfrk is its two members stepped by the JAX parts:
the PF's update, then the RKLT re-seated on the PF's corners and updated
(as `tests/test_torch_pf_nn.py`'s cascade test builds it).

Option legs (`chip_smoke.slice15_options`): the JAX fleet's `update` on
the shared GT leg (seed 3), first 8 trackers (first 128 for the legs of
`chip_smoke.SLICE15_READ_TRACKERS`); the constant border's leg
read apart on its inner trackers and on those that cross the edge, and
run with the replicate border too, whose corners must differ on the
trackers that cross the edge.

Prints per leg and seed the mean corner error per frame and overall, the
median per frame and the trackers lost (beyond `chip_smoke.LOST_PX` on
some frame); then per leg the worst seed's mean, the seeds' medians and
the most lost, the readings `chip_smoke.SLICE15_JAX_READING` holds.
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
from mtf_tpu.ssm import get_ssm  # noqa: E402
from mtf_tpu.utils import synth  # noqa: E402


def sequences(corners):
    """(frames (S, 6, H, W), GT (S, 6, B, 4, 2)) of the per-tracker legs,
    drawn with the homography over all `corners`."""
    out = [synth.synthetic_sequence(cs._scene(0), corners, get_ssm("8"),
                                    n_frames=6, sigma_scale=0.004, seed=sd)
           for sd in cs.SLICE15_SEQ_SEEDS]
    return (np.stack([np.asarray(f) for f, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


def _errors(corners_of, gt_t):
    c = np.asarray(corners_of).transpose(0, 2, 1)
    return np.linalg.norm(c - gt_t, axis=-1).mean(-1)


def multi_leg(key, am, ssm, cfg, corners, seed):
    """(n, 5) errors of the first n trackers, each on its own sequence,
    tracked `chunk` at a time (gtrn one: RegNet's JAX init samples its
    views by dense matmuls over the whole frame, ~6 GB a tracker)."""
    n = cs.SLICE15_GT_TRACKERS
    chunk = 1 if key == "gtrn" else n
    frames, gt = sequences(corners)
    sm = create_tracker(key, am, ssm, **cfg,
                        **({} if seed is None else {"seed": seed}))
    init = jax.jit(jax.vmap(sm.initialize, in_axes=(None, 0)))
    crn = jax.jit(jax.vmap(sm.corners))
    if key == "pfrk":
        first, rk = sm.members
        upd0 = jax.jit(jax.vmap(first.update, in_axes=(0, 0)))
        upd1 = jax.jit(jax.vmap(lambda s, c, f: rk.update(rk.set_region(
            s, c), f), in_axes=(0, 0, 0)))
        crn0 = jax.jit(jax.vmap(first.corners))
        crn1 = jax.jit(jax.vmap(rk.corners))
    else:
        upd = jax.jit(jax.vmap(sm.update, in_axes=(0, 0)))
    out = []
    for i in range(0, n, chunk):
        ids = np.arange(i, min(n, i + chunk))
        st = init(jnp.asarray(frames[0, 0]), jnp.asarray(corners[ids]))
        errs = []
        for t in range(1, frames.shape[1]):
            f = jnp.asarray(frames[ids % cs.SLICE15_SEQS, t])
            want = gt[ids % cs.SLICE15_SEQS, t, ids]
            if key == "pfrk":
                m0, m1 = st.members
                m0 = upd0(m0, f)
                m1 = upd1(m1, jnp.swapaxes(crn0(m0), 1, 2), f)
                st = st._replace(members=(m0, m1))
                errs.append(_errors(crn1(m1), want))
            else:
                st = upd(st, f)
                errs.append(_errors(crn(st), want))
        out.append(np.stack(errs, 1))
    return np.concatenate(out)


def option_leg(key, am, ssm, cfg, corners, seed, n):
    """(n, 5) errors of the first n trackers on the shared GT leg, and
    their corners after each update."""
    sm = create_tracker(key, am, ssm, **cfg,
                        **({} if seed is None else {"seed": seed}))
    frames, gt = synth.synthetic_sequence(cs._scene(0), corners, sm.ssm,
                                          n_frames=6, sigma_scale=0.004,
                                          seed=3)
    frames = np.asarray(frames)
    st = jax.jit(jax.vmap(sm.initialize, in_axes=(None, 0)))(
        jnp.asarray(frames[0]), jnp.asarray(corners[:n]))
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    crn = jax.jit(jax.vmap(sm.corners))
    errs, cs_ = [], []
    for t in range(1, len(frames)):
        st = upd(st, jnp.asarray(frames[t]))
        cs_.append(np.asarray(crn(st)))
        errs.append(_errors(cs_[-1], np.asarray(gt[t])[:n]))
    return np.stack(errs, 1), np.stack(cs_)


def report(name, e, seed, t0):
    med = np.median(e, 0)
    lost = np.flatnonzero(~(e.max(1) <= cs.LOST_PX))
    print(f"{name} seed {seed}, JAX CPU, {len(e)} trackers: "
          f"{float(e.mean()):.4f} px mean (per frame "
          f"{[round(float(x), 4) for x in e.mean(0)]}); median "
          f"{float(med.mean()):.4f} px (per frame "
          f"{[round(float(x), 4) for x in med]}), {len(lost)} lost: "
          f"{lost.tolist()} [{time.perf_counter() - t0:.1f} s]", flush=True)
    return float(e.mean()), float(med.mean()), len(lost)


def main(names=()) -> None:
    legs = {**{k: ("multi",) + v for k, v in cs.slice15_family().items()},
            **{k: ("option",) + v for k, v in cs.slice15_options().items()}}
    for name, (kind, key, am, ssm, b, cfg, _, seeds) in legs.items():
        if names and name not in names:
            continue
        corners = cs.slice15_corners(name, b)
        means, meds, lost = [], [], []
        for seed in seeds:
            t0 = time.perf_counter()
            if kind == "multi":
                e = multi_leg(key, am, ssm, cfg, corners, seed)
            else:
                n = cs.SLICE15_READ_TRACKERS.get(name, cs.SLICE15_GT_TRACKERS)
                e, got = option_leg(key, am, ssm, cfg, corners, seed, n)
            m, md, lo = report(name, e, seed, t0)
            means.append(m)
            meds.append(md)
            lost.append(lo)
            if name == "fclk_ssd_constant":
                # the inner (even) trackers and those across the edge
                report(f"{name} inner", e[0::2], seed, t0)
                report(f"{name} edge", e[1::2], seed, t0)
                _, rep = option_leg(key, am, ssm,
                                    dict(cfg, border="replicate"), corners,
                                    seed, n)
                d = np.abs(got - rep).max(axis=(0, 2, 3))
                print(f"{name}: constant vs replicate corners, the inner "
                      f"trackers' largest {float(d[0::2].max()):.4f} px, "
                      f"those across the edge at least "
                      f"{float(d[1::2].min()):.4f}", flush=True)
        print(f"READING {name}: worst mean {max(means):.4f} px, medians "
              f"{[round(x, 4) for x in meds]} px, at most {max(lost)} lost; "
              f"limit {cs.gt_limit(max(means)):.4f} px (mean) / "
              f"{cs.learned_limit(meds):.4f} px (median)", flush=True)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]))
