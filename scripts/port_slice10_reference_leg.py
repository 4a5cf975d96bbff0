"""The JAX package's readings of the slice-10 GT legs that `chip_smoke.py`
runs on the card (`chip_smoke.slice10_family`), on the CPU, and the
routing runs that go to NaN without LM.

    python scripts/port_slice10_reference_leg.py [part ...] [--nudge N]
        [--fleet NAME]

Parts (default all; `lpfc_ssd` or `gtrn_ssd` alone: that fleet's
`learned` reading): `legs` (hesm over its first 8 trackers; line, esm/rscv
and fclk/ssd + pgb over the whole fleet: the mean corner error per frame
and overall and the limit `chip_smoke.gt_limit` derives from it, the
median per frame and the trackers lost), `learned` (lpfc and gtrn: the
first trackers of `chip_smoke.SLICE10_LEARNED_GT` at each of `GT_SEEDS`,
the mean and median corner error per frame and the trackers lost beyond
`chip_smoke.LOST_PX`; then the seeds' medians, the most lost and
`chip_smoke.learned_limit`), `routing` (each slice-10 AM on FCLK without
LM, 3 updates on the scene at `chip_smoke.B_SLICE10_ROUTING` trackers, as
`chip_smoke._fleet` runs them: the trackers whose corners are not
finite), `not_finite` (the fleets of `chip_smoke.SLICE10_NOT_FINITE`
through the WARMUP + STEPS static updates of their timed run on the
scene, as `chip_smoke._fleet` runs them: the trackers whose corners are
not finite at the end, the update each first went so and how far it
had moved before; esm/rscv over the whole fleet, gtrn over its first
OWN_INIT_TRACKERS and, from the port's init, over the whole fleet; with
`--nudge`, the flips that give `chip_smoke.not_finite_limit` its
variance). Every leg also prints its trackers whose corners went
non-finite.

Same scene, corners, configurations and 6-frame synthetic sequence (sigma
0.004, seed 3, drawn with the tracker's SSM) as `chip_smoke.py`. A fleet
is tracked 8 trackers at a time (one compile per fleet and seed); every
tracker of a JAX fleet draws from the same key, so the result is the one
batch's.
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
from mtf_tpu.utils import synth  # noqa: E402

CHUNK = 8
# not_finite: gtrn's own JAX init over its GT legs' trackers (~40 s each)
OWN_INIT_TRACKERS = {"gtrn_ssd": 16}


def leg_errors(sm, frames, gt, corners, chunk=CHUNK):
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


def _not_finite(e):
    """The trackers of a leg (rows of `leg_errors`) that went non-finite."""
    return int((~np.isfinite(e)).any(1).sum())


def _leg(key, am, ssm, cfg, corners, chunk=CHUNK, nudge=0, **extra):
    """The leg's errors; `nudge` k: its frames moved k float32 ulps up."""
    sm = create_tracker(key, am, ssm, **cfg, **extra)
    frames, gt = synth.synthetic_sequence(
        cs._scene(0), corners, sm.ssm, n_frames=6, sigma_scale=0.004, seed=3)
    frames = np.asarray(frames)
    for _ in range(nudge):
        frames = np.nextafter(frames, np.float32(np.inf))
    return leg_errors(sm, frames, gt, corners, chunk)


def _flips(a, b):
    """The trackers non-finite in one run of two and not in the other
    (for independent runs, its expectation is the variance of the
    difference of their counts)."""
    return len(set(a) ^ set(b))


def legs(nudges=0, fleets=None):
    """Each leg (or those of `fleets`); with `nudges`, a leg with
    non-finite trackers again on its frames moved k = 1..nudges ulps up:
    the count and the flips against the first run."""
    for name in fleets or ("hesm_ssd", "line_ssd", "esm_rscv",
                           "fclk_ssd_pgb"):
        key, am, ssm, b, cfg, _ = cs.slice10_family()[name]
        n = cs.PLAIN_PATH_TRACKERS if name in cs.SLICE10_FIRST8 else b
        t0 = time.perf_counter()
        e = _leg(key, am, ssm, cfg, cs._corners(b)[:n])
        errs = e.mean(0).tolist()
        px = float(np.mean(errs))
        med = np.median(e, 0)
        lost = np.flatnonzero(e.max(1) > cs.LOST_PX)
        print(f"{name} ({key}/{am}/{ssm}), JAX CPU, first {n} of {b} "
              f"trackers: {px:.4f} px mean (per frame "
              f"{[round(x, 4) for x in errs]}); limit {cs.gt_limit(px):.4f} "
              f"px; median {float(med.mean()):.4f} px (per frame "
              f"{[round(float(x), 4) for x in med]}), {len(lost)} lost "
              f"(> {cs.LOST_PX} px on a frame, or not finite): "
              f"{lost.tolist()}; {_not_finite(e)} not finite "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        bad0 = np.flatnonzero(~np.isfinite(e).all(1))
        for k in range(1, nudges + 1 if len(bad0) else 1):
            e2 = _leg(key, am, ssm, cfg, cs._corners(b)[:n], nudge=k)
            bad = np.flatnonzero(~np.isfinite(e2).all(1))
            print(f"{name}: frames {k} ulp up: {len(bad)} not finite, "
                  f"{_flips(bad0, bad)} flips against the first run",
                  flush=True)


def learned(names=("lpfc_ssd", "gtrn_ssd")):
    for name in names:
        key, am, ssm, b, cfg, _ = cs.slice10_family()[name]
        corners = cs._corners(b)[:cs.SLICE10_LEARNED_GT[name][0]]
        # gtrn samples its views by dense matmuls over the whole frame:
        # one tracker at a time keeps that to ~6 GB
        chunk = 1 if name == "gtrn_ssd" else CHUNK
        meds, worst_lost = [], 0
        for seed in cs.GT_SEEDS:
            t0 = time.perf_counter()
            e = _leg(key, am, ssm, cfg, corners, chunk, seed=seed)
            med = np.median(e, 0)
            lost = np.flatnonzero(e.max(1) > cs.LOST_PX)
            meds.append(float(med.mean()))
            worst_lost = max(worst_lost, len(lost))
            print(f"{name} ({key}/{am}/{ssm}) seed {seed}, JAX CPU, "
                  f"{len(corners)} trackers: {float(e.mean()):.4f} px mean "
                  f"(per frame {[round(float(x), 4) for x in e.mean(0)]}); "
                  f"median {float(med.mean()):.4f} px (per frame "
                  f"{[round(float(x), 4) for x in med]}), {len(lost)} lost "
                  f"(> {cs.LOST_PX} px on a frame): {lost.tolist()}; "
                  f"{_not_finite(e)} not finite "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        print(f"{name}: medians {[round(m, 4) for m in meds]} px, at most "
              f"{worst_lost} lost; limit {cs.learned_limit(meds):.4f} px",
              flush=True)


def routing():
    b = cs.B_SLICE10_ROUTING
    frame = jnp.asarray(cs._scene(0))
    frame3 = jnp.asarray(cs._scene3(0))
    corners = jnp.asarray(cs._corners(b))
    for name, (key, am, ssm, cfg, frm, _) in cs.slice10_routing().items():
        if key != "fclk":
            continue
        t0 = time.perf_counter()
        sm = create_tracker(key, am, ssm, **cfg)
        f = frame3 if frm == "rgb" else frame
        st = jax.jit(jax.vmap(sm.initialize, in_axes=(None, 0)))(f, corners)
        upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
        for _ in range(cs.WARMUP):
            st = upd(st, f)
        c = np.asarray(jax.vmap(sm.corners)(st))
        bad = np.flatnonzero(~np.isfinite(c).all(axis=(1, 2)))
        print(f"{name}: JAX CPU, {b} trackers, 3 FCLK updates without LM: "
              f"{len(bad)} not finite {bad.tolist()} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def _static_run(init, upd, corners_of, frame, corners, chunk):
    """`chip_smoke._fleet`'s WARMUP + STEPS updates on the static scene,
    `chunk` trackers at a time: {tracker that ended non-finite: (the
    update (0-based) at which it first went so, how far its corners had
    moved from the initial ones at its last finite update, px)}."""
    out = {}
    for i in range(0, len(corners), chunk):
        st = init(frame, corners[i:i + chunk])
        c0 = np.asarray(corners_of(st))
        last = np.zeros(len(c0))
        first = {}
        for u in range(cs.WARMUP + cs.STEPS):
            st = upd(st, frame)
            c = np.asarray(corners_of(st))
            ok = np.isfinite(c).all(axis=(1, 2))
            moved = np.abs(c - c0).max(axis=(1, 2))
            last = np.where(ok, moved, last)
            for j in np.flatnonzero(~ok):
                first.setdefault(int(j), (u, float(last[j])))
        out.update({i + j: v for j, v in first.items()})
    return out


def _report(who, name, run, n, t0):
    moved = [m for _, m in run.values()]
    print(f"{name}, {who}, first {n} trackers, {cs.WARMUP + cs.STEPS} "
          f"static updates: {len(run)} not finite {sorted(run)}; first "
          f"non-finite update {[run[i][0] for i in sorted(run)]}; moved "
          f"before it: least {min(moved, default=np.nan):.4g} px, median "
          f"{np.median(moved) if moved else np.nan:.4g} px "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def _port_threads():
    """PyTorch's CPU threads for the port's runs here: OpenMP's barriers
    spin, and at more threads than free cores the runs slowed more than
    tenfold."""
    import torch
    torch.set_num_threads(4)


def _from_port_init(name, corners, chunk):
    """A fleet trained by the port on the CPU (its own draws), then the
    WARMUP + STEPS static updates in both packages from that state: for
    each package, as `_static_run` returns. The port trains every chunk
    first, then each package runs alone."""
    import torch
    from mtf_tpu_torch import convert
    from mtf_tpu_torch import create_tracker as port_tracker
    from mtf_tpu_torch.parallel import TrackerFleet
    _port_threads()
    key, am, ssm, _, cfg, _ = cs.slice10_family()[name]
    fleet = TrackerFleet(port_tracker(key, am, ssm, device="cpu", **cfg))
    sm = create_tracker(key, am, ssm, **cfg)
    frame = torch.as_tensor(cs._scene(0))
    with torch.no_grad():
        states = [fleet.initialize(frame,
                                   torch.as_tensor(corners[i:i + chunk]))
                  for i in range(0, len(corners), chunk)]

    def port_upd(st, f):
        with torch.no_grad():
            return fleet.update(st, f)
    port = {}
    for i, st in zip(range(0, len(corners), chunk), states):
        run = _static_run(lambda f, c: st, port_upd, fleet.corners, frame,
                          corners[i:i + chunk], chunk)
        port.update({i + j: v for j, v in run.items()})
    jinit = jax.vmap(sm.initialize, in_axes=(None, 0))
    upd = jax.jit(jax.vmap(sm.update, in_axes=(0, None)))
    crn = jax.jit(jax.vmap(sm.corners))
    jframe = jnp.asarray(cs._scene(0))
    jx = {}
    for i, st in zip(range(0, len(corners), chunk), states):
        c = jnp.asarray(corners[i:i + chunk])
        tree = jax.tree.structure(jax.eval_shape(jinit, jframe, c))
        leaves = [jnp.asarray(x) for x in jax.tree.leaves(
            convert.to_numpy(st))]
        jst = jax.tree.unflatten(tree, leaves)
        run = _static_run(lambda f, c: jst, upd, crn, jframe, c, chunk)
        jx.update({i + j: v for j, v in run.items()})
    return port, jx


def not_finite(nudges=0, fleets=None):
    """Each fleet of `chip_smoke.SLICE10_NOT_FINITE` in the JAX package
    and, for `nudges` k = 1, 2, ..., again on the scene moved k float32
    ulps up, a perturbation at the rounding of the data: the spread of
    the count between summation orders. gtrn, whose trained nets depend on draws
    that differ between the packages, also from the port's init (its
    nets trained on the CPU) over the whole fleet, the updates in both
    packages from that state."""
    frame = cs._scene(0)
    for name in cs.SLICE10_NOT_FINITE:
        if fleets and name not in fleets:
            continue
        key, am, ssm, b, cfg, _ = cs.slice10_family()[name]
        n = OWN_INIT_TRACKERS.get(name, b)
        label = f"{name} ({key}/{am}/{ssm})"
        chunk = 1 if name == "gtrn_ssd" else 64
        if name == "gtrn_ssd":
            t0 = time.perf_counter()
            prt, jx = _from_port_init(name, cs._corners(b), 16)
            _report("the port's init on the CPU, then the port", label, prt,
                    b, t0)
            _report("the port's init on the CPU, then JAX", label, jx, b, t0)
            print(f"{label}: flips between the packages from the port's "
                  f"init {_flips(prt, jx)}", flush=True)
        corners = cs._corners(b)[:n]
        sm = create_tracker(key, am, ssm, **cfg)
        fns = (jax.jit(jax.vmap(sm.initialize, in_axes=(None, 0))),
               jax.jit(jax.vmap(sm.update, in_axes=(0, None))),
               jax.jit(jax.vmap(sm.corners)))
        nudged, runs = frame, []
        for k in range(nudges + 1):
            t0 = time.perf_counter()
            runs.append(_static_run(*fns, jnp.asarray(nudged),
                                    jnp.asarray(corners), chunk))
            _report("JAX CPU" + (f", scene {k} ulp up" if k else ""), label,
                    runs[-1], n, t0)
            if k:
                print(f"{label}: flips against the scene's run "
                      f"{_flips(runs[0], runs[-1])}", flush=True)
            nudged = np.nextafter(nudged, np.float32(np.inf))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", help="legs, routing, learned, "
                    "not_finite, or one fleet of SLICE10_LEARNED_GT")
    ap.add_argument("--nudge", type=int, default=0,
                    help="not_finite, legs: also the frames 1..N ulps up")
    ap.add_argument("--fleet", action="append",
                    help="not_finite, legs: this fleet only (repeatable)")
    args = ap.parse_args()
    for part in args.parts or ["legs", "routing", "learned", "not_finite"]:
        if part in cs.SLICE10_LEARNED_GT:
            learned((part,))
        elif part == "not_finite":
            not_finite(args.nudge, args.fleet)
        elif part == "legs":
            legs(args.nudge, args.fleet)
        else:
            {"learned": learned, "routing": routing}[part]()
