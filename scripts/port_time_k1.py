"""Time the chain kernel's K1 mode (SSD, one channel, linear taps) on the
card, from whichever `mtf_tpu_torch` comes first on `sys.path`.

    PYTHONPATH=<tree> python3 scripts/port_time_k1.py [B N]

Defaults B = 1280, N = 2500 (the headline fleet's full-resolution
iteration). The operands are `chip_smoke.py`'s (`_chain_inputs`, seed 2,
on its scene); the kernel is called through `lk_fused_chain_raw` with
the arguments every version of the port takes, so two trees (a commit
and its parent) can be timed in one call on one card, in turns (parent,
change, change, parent). Prints one JSON line: the median of 5 CUDA-event
timings of 200 launches each, the package's path and the card.
"""
import json
import subprocess
import sys
from pathlib import Path

# this script's repository last: the tree under test comes from PYTHONPATH
sys.path.append(str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(b: int = 1280, n: int = 2500) -> int:
    if not torch.cuda.is_available():
        print("port_time_k1: needs a CUDA device", file=sys.stderr)
        return 1
    import mtf_tpu_torch
    from mtf_tpu_torch.ops.kernels import lk_fused as tk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    frame = torch.as_tensor(cs._scene(0), device=dev)
    args, _ = cs._chain_inputs(torch, frame, n, b, "ssd", False, dev)
    times = sorted(cs._time_ms(torch, lambda: tk.lk_fused_chain_raw(*args),
                               200) for _ in range(5))
    print(json.dumps({"k1_ms": times[2], "k1_ms_all": times, "B": b, "N": n,
                      "package": str(Path(mtf_tpu_torch.__file__).parent),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:3])))
