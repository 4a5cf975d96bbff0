"""Time the chain kernel's K1 mode (SSD, one channel, linear taps) on the
card, from whichever `mtf_tpu_torch` comes first on `sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_time_k1.py [B N [S [blur]]]

Defaults B = 1280, N = 2500 (the headline fleet's full-resolution
iteration), S = 8 (the homography) and blur 0 (plain taps; 2-8 times the
blurred taps, K4b). The operands are `chip_smoke.py`'s (`_chain_inputs`,
seed 2, on its scene, with the warps of an S-DOF SSM); the kernel is
called through `lk_fused_chain_raw` with the arguments every version of
the port takes (a tree from before S and blur were arguments takes only
S = 8 and blur 0), so two trees (a commit and its parent) can be timed in
one call on one card, in turns (parent, change, change, parent). Prints
one JSON line: the median of 5 CUDA-event timings of 200 launches each,
the registers ptxas gave the timed instantiation, the package's path and
the card.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

# this script's repository last: the tree under test comes from PYTHONPATH
sys.path.append(str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# an SSM key of each state size (the parent's chip_smoke may predate them)
SSM_OF_S = {2: "2", 3: "3s", 4: "4", 5: "5", 6: "6", 8: "8"}


def _registers(log: str, blurred: bool) -> int | None:
    """ptxas registers of the SSD, single-channel, linear instantiation
    (the chain kernel's template arguments all 0), of the blurred-tap
    kernel where `blurred`."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(r"lk_fused_chain_(blur_)?kernel", name):
            flags = re.findall(r"Lb([01])E", name)
            kind = re.search(r"Li(\d)E", name).group(1)
            if (flags == ["0", "0", "0"] and kind == "0"
                    and ("blur_kernel" in name) == blurred):
                return int(m.group(1))
    return None


def main(b: int = 1280, n: int = 2500, s: int = 8, blur: int = 0) -> int:
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
    args, _ = cs._chain_inputs(torch, frame, n, b, "ssd", False, dev,
                               **({} if s == 8 else {"ssm_key": SSM_OF_S[s]}))
    kw = {"blur": blur} if blur else {}
    times = sorted(cs._time_ms(torch, lambda: tk.lk_fused_chain_raw(
        *args, **kw), 200) for _ in range(5))
    built = (_build.load("lk_fused_chain", {"LK_S": s})
             if hasattr(tk, "STATE_DIMS") else _build.load("lk_fused_chain"))
    print(json.dumps({"k1_ms": times[2], "k1_ms_all": times, "B": b, "N": n,
                      "S": s, "blur": blur,
                      "registers": _registers(built.log, blur > 1),
                      "package": str(Path(mtf_tpu_torch.__file__).parent),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:5])))
