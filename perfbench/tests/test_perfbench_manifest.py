"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, that every per-layer metric moves an end-to-end metric each of its
cells reports, and that every file a name leads to is there."""

import json
import re
from pathlib import Path

import pytest

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / manifest.MANIFEST).stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert all(line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    r = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert 1 <= r <= 51 and runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads") for e in BENCH[key]]
    names += [m["name"] for m in METRICS]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_per_layer_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, e2e[m["moves"]])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"] if reports(cell, m)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(reports(cell, m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    assert w["chips"] in (1, 4) and line(w["why"])
    cfg_entry = manifest.config(BENCH, w["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert (ROOT / "perfbench" / "tasks" / f"{cfg['_task']}.py").is_file()
    manifest.traffic(ROOT, w["traffic"])
    spec = manifest.cell(ROOT, w["name"])
    numbers = re.compile(r"^(loss(_[a-z]+)?_gap|(grad|delta)_gap(_median|_mean)?)$")
    assert spec["limits"] and all(numbers.match(k) and v > 0
                                  for k, v in spec["limits"].items())
    assert cfg["global_batch_size"] % w["chips"] == 0
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = ROOT / c["file"]
    assert c["file"].startswith("perfbench/") and line(c["source"])
    assert line(c["why"]) and len(c["reduced"]) <= 16
    raw = json.loads(path.read_text())
    assert set(c["reduced"]) <= set(raw)
    assert set(c["reduced"]) == set(raw["_reduced"])
    # the loader that its task names takes it
    manifest.task(ROOT, raw["_task"]).program_config(str(path))
    assert any(c["name"] == w["config"] for w in BENCH["workloads"])


HOOKS = ("REFERENCE", "init_kind", "program_config", "build_model",
         "make_optimizer", "make_step", "step_flops", "step_calls")


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "perfbench" / "tasks").glob("*.py")))
def test_each_task_names_its_model_reference_and_weights(name):
    task = manifest.task(ROOT, name)
    assert all(hasattr(task, hook) for hook in HOOKS)
    reference = manifest.reference(ROOT, task.REFERENCE)
    assert all(callable(getattr(reference, f))
               for f in ("build", "loss", "group_of"))


def test_config_files_are_the_repos_with_the_reductions():
    from egovlpv2_torch.core.config import load_train_config

    home = ROOT / "perfbench" / "configs"
    for mine, repo, rows in (("egovlpv2_pretrain_egoclip", "pretrain_egoclip",
                              64),
                             ("egovlpv2_ft_charades", "ft_charades", 8)):
        got = load_train_config(str(home / f"{mine}.json"))
        want = load_train_config(str(ROOT / "configs" / f"{repo}.json"), [
            "model.remat=false", "path_remat=false",
            f"global_batch_size={rows}"])
        assert got == want
