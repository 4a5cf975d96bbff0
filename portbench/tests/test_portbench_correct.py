"""What decides `correct`, on the CPU at a small size: the program's
answers against the plain reference pass; the control (the program's own
bfloat16 path) and every fault planted under the timed path fail."""
import pytest

from conftest import CELLS, tiny_run
from portbench.lib import faults


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = tiny_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    out = tiny_run(name, options={"interp_bf16": True})
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_fails(name, kind):
    out = tiny_run(name, fault=faults.planting(kind))
    assert not out["correct"], out["checks"]
