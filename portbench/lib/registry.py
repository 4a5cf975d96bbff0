"""Finds the benchmark's parts by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, so a new one is added as a file
and an entry in `BENCHMARK.json`, with no edit to the files that are here:

    configs/<config>.json        the tracker's keys and options, frame size
    reference/<config>.py        the configuration's plain reference
    traffic/<mix>.json           the mix's parameters (lib/generator.py)
    cells/<cell>.json            the cell's sizes and correctness limits
    metrics/<metric>.py          the reader of one per-layer metric
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]          # portbench/
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def cell(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "cells" / f"{name}.json")


def _module(path: Path, label: str):
    if not path.exists():
        raise KeyError(f"no {label} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{label}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = ROOT):
    """The reader module of a per-layer metric: `read(trace) -> float |
    None`, and optionally `WRAP` and `bound` (lib/trace.py)."""
    return _module(root / "metrics" / f"{name}.py", "metric")


def reference(name: str, root: Path = ROOT):
    """The plain reference module of a configuration: `track(...)`."""
    return _module(root / "reference" / f"{name}.py", "reference")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that cell `cell_name`
    reports: those with no `workloads` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
