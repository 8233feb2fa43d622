"""A copy of the benchmark in a temporary root with two cells added as new
files, at widths a CPU test can run: `tiny_pretrain` and `tiny_dual`."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_config(task: str, dtype: str = "bfloat16") -> dict:
    from egovlpv2_torch.core.config import replace
    from egovlpv2_torch.tasks.pretrain import tiny_train_config

    cfg = tiny_train_config()
    model = replace(cfg.model, remat=False, compute_dtype=dtype)
    if task == "dual":
        model = replace(model, projection="small", with_itm_head=False,
                        with_mlm_head=False)
        cfg = replace(cfg, tasks="Dual",
                      loss=replace(cfg.loss, type="NormSoftmax"))
    cfg = replace(cfg, model=model, path_remat=False, global_batch_size=8)
    return {"_task": task, **dataclasses.asdict(cfg)}


def make_root(tmp: Path, dtype: str = "bfloat16",
              limits: dict = None) -> Path:
    """Copies BENCHMARK.json and perfbench/ under `tmp` and adds the tiny
    cells by new files and manifest entries only."""
    root = Path(tmp) / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    home = root / "perfbench"
    limits = limits or {"loss_gap": 0.05, "grad_gap": 0.2,
                        "delta_gap": 0.2}
    for task, traffic in (("pretrain", "egoclip_pool4"),
                          ("dual", "charades_pool4")):
        name = f"tiny_{task}"
        (home / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(task, dtype)))
        (home / "cells" / f"{name}.json").write_text(json.dumps(
            {"checked_steps": 3, "profiled_steps": 2, "limits": limits}))
        bench["configs"].append({
            "name": name, "source": "https://arxiv.org/abs/2307.05463",
            "file": f"perfbench/configs/{name}.json", "reduced": [],
            "why": "a test's widths"})
        bench["workloads"].append({
            "name": name, "config": name, "traffic": traffic, "chips": 1,
            "why": "a test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (task == "dual" or
                                     m["name"] != "step_ms_p95"):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
