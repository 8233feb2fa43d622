"""`BENCHMARK.json` and the files it names, found by name under the root
of a checkout: a configuration's file as the manifest gives it, a traffic
mix at `perfbench/traffic/<traffic>.json`, a cell's limits at
`perfbench/cells/<cell>.json`, a task at `perfbench/tasks/<task>.py` (the
configuration file's "_task"), the task's reference at
`perfbench/reference/<REFERENCE>.py` (the task's `REFERENCE`) and a
metric's reader at `perfbench/metrics/<metric>.py`. A later change adds
any of them as new files and manifest entries, and edits none of these."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

MANIFEST = "BENCHMARK.json"
HOME = "perfbench"


def load(root: Path) -> dict:
    with open(Path(root) / MANIFEST) as f:
        return json.load(f)


def _one(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {MANIFEST}")


def workload(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    return _one(bench["configs"], name, "config")


def read_json(root: Path, *parts: str) -> dict:
    with open(Path(root).joinpath(*parts)) as f:
        return json.load(f)


def traffic(root: Path, name: str) -> dict:
    return read_json(root, HOME, "traffic", f"{name}.json")


def cell(root: Path, name: str) -> dict:
    return read_json(root, HOME, "cells", f"{name}.json")


def module(path: Path) -> ModuleType:
    """The Python file at `path` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def task(root: Path, name: str) -> ModuleType:
    return module(Path(root) / HOME / "tasks" / f"{name}.py")


def reference(root: Path, name: str) -> ModuleType:
    return module(Path(root) / HOME / "reference" / f"{name}.py")


def reader(root: Path, metric: str) -> ModuleType:
    return module(Path(root) / HOME / "metrics" / f"{metric}.py")


def metrics_of(bench: dict, cell_name: str, traced: bool) -> List[dict]:
    """The metrics a run of `cell_name` reports: its end-to-end metrics
    untraced, its per-layer metrics traced; a metric with a "workloads"
    list only in those cells."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]
