"""Where the CUDA path and the plain path of an RKLT fleet part, on the
card: in the grid or in the LM refiner, and at which accept/reject step.

    python3 scripts/port_plain_path_parting.py [fleet chunks] ...

Each argument pair is a fleet (`rklt`, or a name of
`chip_smoke.grid_family` such as `rklt_cubic`) and the chain kernel's
32-point chunks per warp (`lk_fused.CHUNKS_PER_WARP`, set for the run);
default "rklt 2 rklt_cubic 2". Runs `chip_smoke._plain_path_check`'s
comparison: its first 8 trackers over frames 1-2 of the GT leg, on the
card and on the CPU (the plain forms), the CPU grid handed the card's
RANSAC draws. Per tracker: the corner difference after each frame, the
grid stage's (before the refiner), and the refiner's first LM
accept/reject step that differs between the paths, with each path's
relative objective change there (f_new - f_prev) / |f_prev| (a step is
kept where f does not fall, `sm/lk.py`). Prints one JSON line per fleet.
"""
import functools
import importlib.util
import json
import sys
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               _REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

TRACKERS = 8


def _record(fn, log, *args, **kw):
    out = fn(*args, **kw)
    log.append(out)
    return out


def _accepts(fs, schedule):
    """(update, phase iterations, iteration, accepted, f_prev, f_new) of
    every LM step, from the objective values of one tracker in call order
    (per phase: f_prev, then f_new per iteration)."""
    out, i = [], 0
    for upd in range(2):
        for n_it in schedule:
            prev = fs[i]
            i += 1
            for k in range(n_it):
                new = fs[i]
                i += 1
                out.append((upd, n_it, k, new >= prev, prev, new))
                prev = new if new >= prev else prev
    return out


def run(fleet: str, chunks: int) -> dict:
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.ops.kernels import lk_fused as tk
    from mtf_tpu_torch.sm.core import image_corners
    from mtf_tpu_torch.sm.grid import GridTracker
    from mtf_tpu_torch.utils.synth import synthetic_sequence
    tk.CHUNKS_PER_WARP = chunks
    dev = torch.device("cuda", 0)
    if fleet == "rklt":
        key, cfg = "rklt", cs.rklt_cfg()
    else:
        key, _, _, cfg, _ = cs.grid_family()[fleet]
    corners = cs._corners(cs.B_RKLT)
    sms = {"cuda": create_tracker(key, "ssd", "8", device=dev, **cfg),
           "cpu": create_tracker(key, "ssd", "8", device="cpu", **cfg)}
    frames, _ = synthetic_sequence(cs._scene(0), corners, sms["cuda"].ssm,
                                   n_frames=6, sigma_scale=0.004, seed=3)
    grids = {k: [m for m in sm.modules() if isinstance(m, GridTracker)][0]
             for k, sm in sms.items()}
    grids["cpu"]._hyp_indices = (lambda draw: lambda step, n: draw(
        step, n).cpu())(grids["cuda"]._hyp_indices)
    f_log, grid_log = {}, {}
    for k, sm in sms.items():
        f_log[k], grid_log[k] = [], []
        sm.templ_sm._f = functools.partial(_record, sm.templ_sm._f, f_log[k])
        sm.grid_sm.update = functools.partial(_record, sm.grid_sm.update,
                                              grid_log[k])
    sub = corners[:TRACKERS]
    st = {"cuda": sms["cuda"].initialize(torch.as_tensor(frames[0],
                                                         device=dev), sub),
          "cpu": sms["cpu"].initialize(torch.as_tensor(frames[0]), sub)}
    out = {"fleet": fleet, "chunks": chunks, "final_px": [], "grid_px": []}
    for t in (1, 2):
        for k, sm in sms.items():
            st[k] = sm.update(st[k], torch.as_tensor(
                frames[t], device=dev if k == "cuda" else "cpu"))
        out["final_px"].append(
            (sms["cuda"].corners(st["cuda"]).cpu()
             - sms["cpu"].corners(st["cpu"])).abs().flatten(1).amax(1)
            .tolist())
        g = [image_corners(sms[k].grid_sm.ssm, grid_log[k][-1]).cpu()
             for k in ("cuda", "cpu")]
        out["grid_px"].append((g[0] - g[1]).abs().flatten(1).amax(1)
                              .tolist())
    sched = [n for _, n in cfg["coarse_pt_iters"]]
    sched.append(cfg["max_iters"] - sum(sched))
    out["first_lm_flip"] = []
    for b in range(TRACKERS):
        steps = {k: _accepts([float(f[b]) for f in f_log[k]], sched)
                 for k in ("cuda", "cpu")}
        flip = next(((a, c) for a, c in zip(steps["cuda"], steps["cpu"])
                     if a[3] != c[3]), None)
        out["first_lm_flip"].append(None if flip is None else {
            "update": flip[0][0], "phase_iters": flip[0][1],
            "iteration": flip[0][2],
            "accepted": {"cuda": flip[0][3], "cpu": flip[1][3]},
            "rel_change": {k: (s[5] - s[4]) / abs(s[4])
                           for k, s in zip(("cuda", "cpu"), flip)}})
    return out


def main(*argv) -> int:
    if not torch.cuda.is_available():
        print("port_plain_path_parting: needs a CUDA device",
              file=sys.stderr)
        return 1
    pairs = list(zip(argv[0::2], argv[1::2])) or [("rklt", "2"),
                                                   ("rklt_cubic", "2")]
    for fleet, chunks in pairs:
        print(json.dumps(run(fleet, int(chunks))))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
