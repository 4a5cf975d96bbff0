"""Time the chain kernel on the card, from whichever `mtf_tpu_torch` comes
first on `sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_time_k1.py [B N [S [blur [kind]]]]
    PYTHONPATH=<tree> python3 scripts/port_time_k1.py table
    PYTHONPATH=<tree> python3 scripts/port_time_k1.py sweep

The first form times the SSD mode (one channel) at B trackers of N points
each: defaults B = 1280, N = 2500 (the headline fleet's full-resolution
iteration; N may be a comma list, e.g. 169,625,2500, the three phases of
an update), S = 8 (the homography), blur 0 (plain taps; 2-8 times the
blurred taps, K4b) and kind linear (K1; cubic or cubic_bspl time K1c).
`table` times every chain row of PERF.md's kernel table at its shape:
each mode and tap kind at its fleet's B and N = 2500, K1 and K1c
ssd@cubic also at N = 169 and 625, SSD linear at S = 2-6, ssd:s2 at the
sub-tracker grid's shapes, and K4b at blur 2. `sweep` (a tree with
`lk_fused.block_warps`) times K1 at N = 169, 625 and 2500 and ssd:s2 at
the sub-tracker grid's shapes at every block size of 1-8 warps.

The operands are this repository's `chip_smoke.py`'s (`_chain_inputs`, seed 2,
on its scene, with the warps of an S-DOF SSM); the kernel is called through
`lk_fused_chain_raw` with the arguments every version of the port since its
state sizes takes, so two trees (a commit and its parent) can be timed in one
call on one card, in turns (parent, change, change, parent). Prints one JSON
line: per row the device time of one launch (`chip_smoke._graph_ms`) and the
time of one eager call (200 calls between CUDA events, the host's launch time
included), the registers and spill bytes ptxas gave every chain instantiation
of the state sizes timed, the package's path and the card.
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


# an SSM key of each state size
SSM_OF_S = {2: "2", 3: "3s", 4: "4", 5: "5", 6: "6", 8: "8"}
B_SSD, B_OTHER, B_MC = 1280, 1024, 512       # the fleets' B (chip_smoke)


def table_rows():
    """(label, am, esm, channels, kind, S, blur, B, N, window) of every
    chain row of PERF.md's kernel table."""
    rows = []
    modes = (("K1", "ssd", False, 1), ("K2", "ncc", False, 1),
             ("K3", "ssd", True, 1), ("K2+K3", "ncc", True, 1),
             ("K4", "ssd", False, 3))
    for kind in ("linear", "cubic", "cubic_bspl"):
        for label, am, esm, c in modes:
            b = B_SSD if label == "K1" else (B_MC if c > 1 else B_OTHER)
            ns = (169, 625, 2500) if label == "K1" and kind != "cubic_bspl" \
                else (2500,)
            for n in ns:
                rows.append((label if kind == "linear" else f"{label}@{kind}",
                             am, esm, c, kind, 8, 0, b, n, 144))
    for s in (2, 3, 4, 5, 6):
        rows.append((f"K1:s{s}", "ssd", False, 1, "linear", s, 0, B_SSD,
                     2500, 144))
    for n in (16, 64):
        rows.append(("K1:s2 sub-grid", "ssd", False, 1, "linear", 2, 0,
                     384 * 100, n, 32))
    rows.append(("K1+K4b blur 2", "ssd", False, 1, "linear", 8, 2, B_SSD,
                 625, 144))
    return rows


def _time(tk, frames, dev, row):
    label, am, esm, c, kind, s, blur, b, n, size = row
    args, j0 = cs._chain_inputs(torch, frames[c], n, b, am, esm, dev,
                                ssm_key=SSM_OF_S[s], size=size, span=size)
    kw = dict(am=am, j0=j0, kind=kind)
    if blur:
        kw["blur"] = blur
    def run():
        return tk.lk_fused_chain_raw(*args, **kw)

    ms, eager = cs._graph_ms(torch, run), cs._time_ms(torch, run, 200)
    del args, j0
    torch.cuda.empty_cache()
    return {"ms": ms, "ms_eager": eager, "B": b, "N": n, "S": s, "C": c,
            "kind": kind, "blur": blur}


def main(*argv) -> int:
    if not torch.cuda.is_available():
        print("port_time_k1: needs a CUDA device", file=sys.stderr)
        return 1
    import mtf_tpu_torch
    from mtf_tpu_torch.ops.kernels import _build
    from mtf_tpu_torch.ops.kernels import lk_fused as tk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frame = torch.as_tensor(cs._scene(0), device=dev)
    frames = {1: frame, 3: torch.as_tensor(cs._scene3(0), device=dev)}
    sweep = argv[:1] == ("sweep",)
    if argv[:1] == ("table",):
        rows = table_rows()
    elif sweep:
        rows = [r for r in table_rows() if r[0] in ("K1", "K1:s2 sub-grid")]
    else:
        b, ns, s, blur, kind = (list(argv) + [None] * 5)[:5]
        b, s, blur = int(b or 1280), int(s or 8), int(blur or 0)
        kind = kind or "linear"
        rows = [(f"ssd:s{s}@{kind}", "ssd", False, 1, kind, s, blur, b,
                 int(n), 144) for n in (ns or "2500").split(",")]
    sizes = sorted({r[5] for r in rows})
    libs = _build.load_all([("lk_fused_chain", {"LK_S": s}) for s in sizes])
    out = {}
    for row in rows:
        out[f"{row[0]} N={row[8]}"] = _time(tk, frames, dev, row)
        if sweep:
            default, out[f"{row[0]} N={row[8]}"]["warps"] = (
                tk.block_warps, tk.block_warps(row[8]))
            for w in range(1, tk.MAX_WARPS + 1):
                tk.block_warps = lambda n, w=w: w
                out[f"{row[0]} N={row[8]} warps={w}"] = _time(tk, frames,
                                                             dev, row)
            tk.block_warps = default
    regs = {}
    for s in sizes:
        log = libs[_build.lib_key("lk_fused_chain", {"LK_S": s})].log
        for key, use in cs._ptxas_usage(log).items():
            regs[f"s{s} {key}"] = list(use)
    print(json.dumps({"rows": out, "registers": regs,
                      "package": str(Path(mtf_tpu_torch.__file__).parent),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
