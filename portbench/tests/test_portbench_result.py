"""The result line: its keys, in their order, with `checks` last; the
metrics the cell reports; and no result where there is no card or no
program."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, tiny_run
from portbench.lib import registry

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_keys(trace):
    name = "mf_ssd_hom8.streams"
    out = json.loads(json.dumps(tiny_run(name, trace=trace)))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = registry.benchmark()
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
        allowed = {m["name"] for m in registry.metrics_of(bench, name,
                                                          "per_layer")}
        # no device on the CPU: only the host span reads something
        assert set(out["metrics"]) == {"host_ms_per_step"} <= allowed
    else:
        assert set(out["metrics"]) == {m["name"] for m in
                                       registry.metrics_of(bench, name,
                                                           "end_to_end")}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fclk_ssd_hom8.streams", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_on_the_card(cuda_device):
    """A short traced run on the card reads the device's trace."""
    from portbench.lib import cell
    import time
    out = cell.run_cell("fclk_ssd_hom8.streams", 77, 1.0, True, cuda_device,
                        time.perf_counter(),
                        sizes={"cameras": 64, "check_trackers": 16})
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    m = out["metrics"]
    assert m["launches_per_step"]["value"] > 0
    assert 0 < m["chain_roofline_pct"]["value"] <= 105
