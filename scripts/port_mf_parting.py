"""Which Median Flow patches part the grid-flow kernel from its float32
plain form, how ill-conditioned they are, and what the tracker makes of
them, on the card, from whichever `mtf_tpu_torch` comes first on
`sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_mf_parting.py [B]

One update of `chip_smoke.py`'s Median Flow fleet (B = 384 by default) on
its scene moved by (3, 2) px, its six grid-flow calls recorded (3 levels,
20 iterations, forward then back). For each call, every disp component
beyond `chip_smoke.K5_MAX` between the kernel and the float32 plain form
is listed with its tracker and patch, the three distances (kernel -
plain, kernel - float64, plain - float64) and the patch's condition at
the last iteration: det H and det H / (Hxx Hyy) of the damped 2x2 system
at the float64 plain form's last iterate. Then the whole update runs
twice from the same state, once through the kernel and once with the
plain form on the card in its place: for each parting patch, its
forward-backward weight (fb 2.0 px) in both runs, and for its tracker the
largest corner difference between the runs (px), beside the largest over
all trackers. Prints one JSON line, with the package's path and the card.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

# the tree under test, its mtf_tpu_torch, comes from PYTHONPATH (this
# script's repository last); this repository's chip_smoke.py, by path (a
# tree has its own), gives every tree the same operands and timing
_REPO = Path(__file__).resolve().parents[1]
sys.path.append(str(_REPO))
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               _REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


def _last_condition(gf, interp, call):
    """det H and det H / (Hxx Hyy) per patch (B, P) of the damped 2x2
    system at the float64 plain form's last iterate."""
    win, pts, templ, scale, n, n_iters, zncc, kind = call
    w, p, t, s = (a.double() for a in (win, pts, templ, scale))
    disp = gf.grid_flow_ref(w, p, t, s, n, n_iters - 1, zncc, kind)
    b, pn = t.shape
    off = (disp * s[:, None, None]).repeat_interleave(n, dim=1)
    _, dx, dy = interp.sample_windows(w, p[:, 0] + off[..., 0],
                                      p[:, 1] + off[..., 1], need_grad=True,
                                      kind=kind)
    jx = (dx * s[:, None]).reshape(b, pn // n, n)
    jy = (dy * s[:, None]).reshape(b, pn // n, n)
    hxx = (jx * jx).sum(-1) + 1e-6
    hyy = (jy * jy).sum(-1) + 1e-6
    hxy = (jx * jy).sum(-1)
    det = hxx * hyy - hxy * hxy
    return det, det / (hxx * hyy)


def main(b: int = 384) -> int:
    if not torch.cuda.is_available():
        print("port_mf_parting: needs a CUDA device", file=sys.stderr)
        return 1
    import mtf_tpu_torch
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.ops import interp, ransac
    from mtf_tpu_torch.ops.kernels import grid_flow as gf
    from mtf_tpu_torch.sm import grid as grid_mod
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frame = torch.as_tensor(cs._scene(0), device=dev)
    moved = torch.roll(frame, (3, 2), (0, 1))
    key, _, _, cfg, _ = cs.grid_family()["mf"]
    sm = create_tracker(key, "ssd", "8", device=dev, **cfg)
    st = sm.initialize(frame, cs._corners(b))

    calls, weights = [], []
    real_flow, real_fit = grid_mod.grid_flow, ransac.robust_fit

    def record(win, pts, templ, scale, n, n_iters, zncc=True, kind="linear"):
        calls.append((win, pts, templ, scale, n, n_iters, zncc, kind))
        return real_flow(win, pts, templ, scale, n, n_iters, zncc, kind)

    def plain(win, pts, templ, scale, n, n_iters, zncc=True, kind="linear"):
        return gf.grid_flow_ref(win, pts, templ, scale, n, n_iters, zncc,
                                kind)

    def fit(*args, weights=None, **kw):
        weights_of_run.append(None if weights is None else weights.clone())
        return real_fit(*args, weights=weights, **kw)

    corners = {}
    for run, flow in (("kernel", record), ("plain", plain)):
        weights_of_run = []
        grid_mod.grid_flow, ransac.robust_fit = flow, fit
        try:
            new = sm.update(st, moved)
        finally:
            grid_mod.grid_flow, ransac.robust_fit = real_flow, real_fit
        corners[run] = sm.corners(new).double()
        weights.append(weights_of_run[-1])
    torch.cuda.synchronize()

    levels = len(calls) // 2
    parting, per_call = [], {}
    for i, call in enumerate(calls):
        label = f"{'fwd' if i < levels else 'back'} {levels - 1 - i % levels}"
        got = gf.grid_flow(*call)
        want = gf.grid_flow_ref(*call)
        want64 = gf.grid_flow_ref(*(a.double() for a in call[:4]),
                                  *call[4:])
        d = (got - want).abs()
        det, rel = _last_condition(gf, interp, call)
        far = (d > cs.K5_MAX).nonzero().tolist()
        per_call[label] = {"n_far": len(far), "max": float(d.max()),
                           "rel_det_min": float(rel.min()),
                           "rel_det_median": float(rel.median())}
        for tb, tp, comp in far:
            parting.append({
                "call": label, "tracker": tb, "patch": tp, "comp": comp,
                "cuda_plain": float(d[tb, tp, comp]),
                "cuda_f64": float((got[tb, tp, comp].double()
                                   - want64[tb, tp, comp]).abs()),
                "plain_f64": float((want[tb, tp, comp].double()
                                    - want64[tb, tp, comp]).abs()),
                "det": float(det[tb, tp]), "rel_det": float(rel[tb, tp]),
                "fb_weight_kernel": (None if weights[0] is None
                                     else float(weights[0][tb, tp])),
                "fb_weight_plain": (None if weights[1] is None
                                    else float(weights[1][tb, tp])),
                "tracker_corner_diff_px": float(
                    (corners["kernel"][tb] - corners["plain"][tb]).abs()
                    .max())})
    print(json.dumps({
        "parting": parting, "calls": per_call,
        "corner_diff_px_max": float((corners["kernel"] - corners["plain"])
                                    .abs().max()),
        "fb_dropped_kernel": (None if weights[0] is None
                              else int((weights[0] == 0).sum())),
        "fb_dropped_plain": (None if weights[1] is None
                             else int((weights[1] == 0).sum())),
        "B": b, "package": str(Path(mtf_tpu_torch.__file__).parent),
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
