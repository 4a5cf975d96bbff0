"""Build every kernel library of whichever `mtf_tpu_torch` comes first on
`sys.path`, side by side, and write each instantiation's registers and
spills as JSON: the chain kernel at every S (plain and blurred taps), K6
and the grid flow.

    PYTHONPATH=<tree> python3 scripts/port_ptxas_regs.py OUT.json

Needs `nvcc` (the card's machine); each tree builds into its own
`mtf_tpu_torch/_build/`, so several trees (a change and variants of it
unpacked under a gitignored directory) can be built in one call, one
process each, and their JSON files compared. Prints the tree and its
build time.
"""
import json
import sys
import time
from pathlib import Path

# this script's repository last: the tree under test comes from PYTHONPATH
sys.path.append(str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtf_tpu_torch.ops.kernels import _build  # noqa: E402


def main(out: str) -> int:
    t0 = time.perf_counter()
    specs = [("lk_fused_chain", {"LK_S": s}) for s in cs.STATE_DIMS] \
        + ["lk_fused_gn", "grid_flow"]
    libs = _build.load_all(specs)
    res = {"tree": str(Path(_build.__file__).parents[3]),
           "wall_s": time.perf_counter() - t0, "chain": {}, "gn": {},
           "k5": {}}
    for s in cs.STATE_DIMS:
        log = libs[_build.lib_key("lk_fused_chain", {"LK_S": s})].log
        for key, use in cs._ptxas_usage(log).items():
            res["chain"][f"s{s} {key}"] = use
    for key, use in cs._ptxas_gn(libs["lk_fused_gn"].log).items():
        res["gn"][str(key)] = use
    for key, use in cs._ptxas_k5(libs["grid_flow"].log).items():
        res["k5"][str(key)] = use
    Path(out).write_text(json.dumps(res, indent=0))
    print(res["tree"], f"built in {res['wall_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
