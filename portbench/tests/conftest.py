"""Shared helpers of the benchmark's CPU tests: small runs of a cell on
the CPU, through the harness's own `run_cell` (its look for a chip is
the command's, which these skip)."""
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("fclk_ssd_hom8.streams", "mf_ssd_hom8.streams")
TINY = {"cameras": 3, "warmup_steps": 2, "check_trackers": 3,
        "check_steps_per_tracker": 2, "profiled_steps": 2, "probe_steps": 1}


def tiny_run(name, seed=20240611, seconds=0.3, trace=False, **kw):
    """One small run of cell `name` on the CPU: its result object."""
    from portbench.lib import cell
    torch.set_num_threads(2)
    sizes = {**TINY, **kw.pop("sizes", {})}
    return cell.run_cell(name, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter(), sizes=sizes, **kw)


@pytest.fixture
def cuda_device():
    """The card, decided here (never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu portbench/tests)")
    return torch.device("cuda", 0)
