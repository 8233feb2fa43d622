"""A copy of the benchmark in a temporary root with three cells added as
new files and manifest entries, at widths a CPU test can run:
`tiny_pretrain` and `tiny_dual` (EgoVLPv2's two tasks) and `tiny_clip`, a
third architecture (LaViLa's dual encoder in small) whose task, model and
reference are new files too (`perfbench/tests/tiny_clip/`)."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CLIP = Path(__file__).resolve().parent / "tiny_clip"
# the third architecture's new files, under the copy's perfbench/
CLIP_FILES = {"tasks/tiny_clip.py": CLIP / "task.py",
              "reference/tiny_clip.py": CLIP / "reference.py"}
# its limits, between the bf16 program's readings and the float8
# control's on the CPU at seed 2**31 + 101: loss 5.3e-4 / 0.039, gradient
# 0.0105 / 0.243, change 0.0079 / 0.073 (half of the batch: 0.45, 0.85,
# 0.30)
CLIP_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.1, "delta_gap": 0.1}


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


def clip_config(dtype: str = "bfloat16") -> dict:
    """The third architecture at toy widths: 2 frames of 2 x 2 patches, 2
    video and 2 text blocks, 12 tokens, 8 rows."""
    return {
        "_task": "tiny_clip",
        "model": {
            "video": {"img_size": 32, "patch_size": 16, "in_chans": 3,
                      "num_frames": 2, "width": 32, "layers": 2, "heads": 2},
            "text": {"vocab_size": 256, "context_length": 12, "width": 32,
                     "layers": 2, "heads": 2},
            "embed_dim": 16, "compute_dtype": dtype, "remat": False},
        "optim": {"lr": 3e-5, "lr_mult_head": 1.0,
                  "lr_mult_cross_modal": 1.0, "weight_decay": 0.01,
                  "betas": [0.9, 0.98], "eps": 1e-8, "decay_power": "cosine",
                  "warmup_frac": 0.1, "end_lr": 1e-7, "max_steps": 10,
                  "grad_clip": None},
        "global_batch_size": 8, "max_text_len": 12}


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
    for dest, src in CLIP_FILES.items():
        shutil.copy(src, home / dest)
    (home / "traffic" / "tiny_clip_pool3.json").write_text(json.dumps(
        {"pool_batches": 3, "parts": ["video", "text"], "text_len_min": 4}))
    cells = (("tiny_pretrain", tiny_config("pretrain", dtype),
              "egoclip_pool4", "https://arxiv.org/abs/2307.05463", limits),
             ("tiny_dual", tiny_config("dual", dtype), "charades_pool4",
              "https://arxiv.org/abs/2307.05463", limits),
             ("tiny_clip", clip_config(dtype), "tiny_clip_pool3",
              "https://arxiv.org/abs/2212.04501", CLIP_LIMITS))
    for name, cfg, traffic, source, cell_limits in cells:
        (home / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (home / "cells" / f"{name}.json").write_text(json.dumps(
            {"checked_steps": 3, "profiled_steps": 2,
             "limits": cell_limits}))
        bench["configs"].append({
            "name": name, "source": source,
            "file": f"perfbench/configs/{name}.json", "reduced": [],
            "why": "a test's widths"})
        bench["workloads"].append({
            "name": name, "config": name, "traffic": traffic, "chips": 1,
            "why": "a test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
