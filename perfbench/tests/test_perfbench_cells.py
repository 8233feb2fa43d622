"""A cell added as new files (a configuration, a cell file and manifest
entries, in a temporary copy) is found and run with no edit; the run's
line has the contract's keys; with the timed path broken underneath, or
with the float8 control in the program's place, `correct` comes out
false."""

import math
import time

import pytest
import torch

from perfbench import calibrate, compare, harness

SEED = 2 ** 31 + 101
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(root, cell, traced=False):
    return harness.run_cell(root, cell, SEED, 0.5, traced, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
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


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
def test_new_cell_runs_traced(tiny_root, cell):
    r = run(tiny_root, cell, traced=True)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    # on the CPU the trace holds no device event: the device's readers
    # find nothing and their metrics are left out
    assert {"host_ms_per_step.train", "mfu.train"} <= set(r["metrics"])
    assert "gemm_ms_per_step.train" not in r["metrics"]
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
def test_state_left_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    r = run(tiny_root, cell)
    assert r["correct"] is False
    assert r["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
def test_half_the_batch_is_not_correct(tiny_root, cell):
    with calibrate.half_batch():
        r = run(tiny_root, cell)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
def test_float8_control_is_not_correct(tiny_root, cell):
    c = harness.Cell(tiny_root, cell)
    got = calibrate.readings(c, SEED, "cpu", "control")
    numbers = {k: got[k] for k in c.spec["limits"]}
    assert not compare.judge(numbers, c.spec["limits"])
    assert all(math.isfinite(v) for v in numbers.values())
