"""BENCHMARK.json against the benchmark's contract, and every part found
by name: a new configuration, mix, cell, metric or reference is a file of
its own that needs no edit of the files that are there."""
import json
import re
import shutil

import pytest

from portbench.lib import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (registry.REPO / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "\n" not in m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["config", "traffic", "cell", "reference",
                                  "metric"])
def test_every_part_found_by_name(bench, kind):
    for w in bench["workloads"]:
        if kind == "config":
            cfg = registry.config(w["config"])
            assert cfg["name"] == w["config"] and cfg["source"]
        elif kind == "traffic":
            assert registry.traffic(w["traffic"])["frames"]
        elif kind == "cell":
            size = registry.cell(w["name"])
            assert size["cameras"] > 0 and size["limits"]
        elif kind == "reference":
            assert callable(registry.reference(w["config"]).track)
        else:
            got = registry.metrics_of(bench, w["name"], "per_layer")
            assert got and all(callable(registry.metric(m["name"]).read)
                               for m in got)
            e2e = {m["name"] for m in registry.metrics_of(
                bench, w["name"], "end_to_end")}
            assert "setup_s" in e2e and len(e2e) >= 2


def test_new_parts_need_no_edit(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a mix, a cell, a
    metric and a reference as new files; the harness finds each by name
    and no file that was there changes."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "new_cfg.json").write_text(
        (root / "configs" / "fclk_ssd_hom8.json").read_text())
    (root / "traffic" / "new_mix.json").write_text(json.dumps(
        dict(registry.traffic("streams", root), walk_sigma=0.002)))
    (root / "cells" / "new_cfg.new_mix.json").write_text(json.dumps(
        dict(registry.cell("fclk_ssd_hom8.streams", root), cameras=64)))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(trace):\n    return 1.0\n")
    (root / "reference" / "new_cfg.py").write_text(
        (root / "reference" / "fclk_ssd_hom8.py").read_text())
    big = dict(bench, workloads=bench["workloads"] + [
        {"name": "new_cfg.new_mix", "config": "new_cfg",
         "traffic": "new_mix", "chips": 1, "why": "a new cell"}],
        per_layer=bench["per_layer"] + [
            {"name": "new_metric", "unit": "ms", "better": "lower",
             "source": "program_span", "layer": "sm",
             "moves": "tracker_frames_per_s",
             "workloads": ["new_cfg.new_mix"]}])
    w = registry.workload(big, "new_cfg.new_mix")
    assert registry.config(w["config"], root)["tracker"]["sm"] == "fclk"
    assert registry.traffic(w["traffic"], root)["walk_sigma"] == 0.002
    assert registry.cell(w["name"], root)["cameras"] == 64
    assert callable(registry.reference(w["config"], root).track)
    names = [m["name"] for m in registry.metrics_of(big, w["name"],
                                                      "per_layer")]
    assert "new_metric" in names and "k5_roofline_pct" not in names
    assert registry.metric("new_metric", root).read(None) == 1.0
    assert "new_metric" not in [m["name"] for m in registry.metrics_of(
        big, "fclk_ssd_hom8.streams", "per_layer")]
    assert all(p.read_bytes() == b for p, b in before.items())
