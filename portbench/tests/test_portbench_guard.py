"""The run's own check that neither JAX nor the JAX package is loaded,
by whole top-level module names."""
import shutil
import sys
import types

import pytest

from conftest import tiny_run
from portbench.lib import cell, guard, registry


@pytest.mark.parametrize("names,bad", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["mtf_tpu", "mtf_tpu.ops.interp"], ["mtf_tpu"]),
    (["mtf_tpu_torch", "mtf_tpu_torch.sm.lk", "numpy", "torch"], []),
    (["jax_utils", "mtf_tpu2", "flaxen"], []),
])
def test_top_level_names(names, bad):
    assert guard.forbidden_loaded(names) == bad


def test_the_harness_loads_none():
    tiny_run("fclk_ssd_hom8.streams")
    assert guard.forbidden_loaded() == []


def test_a_run_that_loaded_one_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "mtf_tpu",
                        types.ModuleType("mtf_tpu"))
    with pytest.raises(cell.Forbidden):
        tiny_run("fclk_ssd_hom8.streams")


def test_a_reference_that_loads_one_gives_no_result(tmp_path, monkeypatch):
    """The check runs after the reference: a reference that brings in a
    module named `mtf_tpu` leaves the run without a result."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    ref = root / "reference" / "fclk_ssd_hom8.py"
    ref.write_text(ref.read_text() + "\nimport sys, types\n"
                   "sys.modules['mtf_tpu'] = types.ModuleType('mtf_tpu')\n")
    monkeypatch.delitem(sys.modules, "mtf_tpu", raising=False)
    try:
        with pytest.raises(cell.Forbidden):
            tiny_run("fclk_ssd_hom8.streams", root=root)
    finally:
        sys.modules.pop("mtf_tpu", None)
