"""A cell added as new files (a configuration, a cell file and manifest
entries, in a temporary copy) is found and run with no edit, EgoVLPv2's
two tasks and a third architecture that brings its own task, model,
reference and weight rules; the run's line has the contract's keys; with
the timed path broken underneath, or with the float8 control in the
program's place, `correct` comes out false."""

import json
import math
import time

import pytest
import torch

from perfbench import calibrate, compare, harness
from perfbench.tests.tiny import CLIP_FILES, REPO

SEED = 2 ** 31 + 101
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["tiny_pretrain", "tiny_dual", "tiny_clip"]


def run(root, cell, traced=False):
    return harness.run_cell(root, cell, SEED, 0.5, traced, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_untraced(tiny_root, cell):
    r = run(tiny_root, cell)
    assert list(r) == KEYS
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {"clips_per_s", "setup_s"} | (
        {"step_ms_p95"} if cell == "tiny_dual" else set())
    assert want >= set(r["metrics"]) >= {"clips_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checks"]) == set(harness.Cell(tiny_root, cell).spec[
        "limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_traced(tiny_root, cell):
    r = run(tiny_root, cell, traced=True)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    # on the CPU the trace holds no device event: the device's readers
    # find nothing and their metrics are left out
    assert {"host_ms_per_step.train", "mfu.train"} <= set(r["metrics"])
    assert "gemm_ms_per_step.train" not in r["metrics"]
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    r = run(tiny_root, cell)
    assert r["correct"] is False
    assert r["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_is_not_correct(tiny_root, cell):
    with calibrate.half_batch():
        r = run(tiny_root, cell)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_is_not_correct(tiny_root, cell):
    c = harness.Cell(tiny_root, cell)
    got = calibrate.readings(c, SEED, "cpu", "control")
    numbers = {k: got[k] for k in c.spec["limits"]}
    assert not compare.judge(numbers, c.spec["limits"])
    assert all(math.isfinite(v) for v in numbers.values())


def test_new_cells_are_new_files_and_entries_only(tiny_root):
    """The copy holds every file of the tree's perfbench/ byte for byte,
    and its manifest less the added entries is the tree's."""
    home, copy = REPO / "perfbench", tiny_root / "perfbench"

    def files(root):
        return {str(f.relative_to(root)) for f in root.rglob("*")
                if f.is_file() and "__pycache__" not in f.parts}

    mine, theirs = files(home), files(copy)
    assert mine <= theirs
    assert all((home / f).read_bytes() == (copy / f).read_bytes()
               for f in mine)
    assert theirs - mine == set(CLIP_FILES) | {
        "traffic/tiny_clip_pool3.json"} | {
        f"{where}/{cell}.json" for where in ("configs", "cells")
        for cell in CELLS}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        bench[key] = [e for e in bench[key] if e["name"] not in CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    assert bench == json.loads((REPO / "BENCHMARK.json").read_text())
