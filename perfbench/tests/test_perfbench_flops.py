"""The step's operation count against PyTorch's FlopCounterMode over the
port's own step at tiny widths on the CPU, where every attention is plain
matrix products."""

import dataclasses
import json
import tempfile

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops
from perfbench.tests.tiny import tiny_config


@pytest.mark.parametrize("task", ["pretrain", "dual"])
def test_count_matches_flop_counter(task):
    from egovlpv2_torch.core.config import load_train_config
    from egovlpv2_torch.tasks.pretrain import build_pretrain, synthetic_batch
    from egovlpv2_torch.tasks.retrieval import build_dual

    cfg_dict = tiny_config(task, "float32")
    build = build_pretrain if task == "pretrain" else build_dual
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump({k: v for k, v in cfg_dict.items()
                   if not k.startswith("_")}, f)
        f.flush()
        cfg = load_train_config(f.name)
    rows = 6
    torch.manual_seed(0)
    _, _, _, step = build(cfg, "cpu")
    batch = synthetic_batch(cfg, rows, np.random.default_rng(0))
    step(batch)
    with FlopCounterMode(display=False) as counter:
        step(batch)
    counted = (flops.pretrain(cfg_dict, rows) if task == "pretrain"
               else flops.dual(cfg_dict, rows))
    assert counted["useful"] + counted["recomputed"] \
        == counter.get_total_flops()
    assert dataclasses.asdict(cfg)["model"] == cfg_dict["model"]


def test_full_width_counts():
    """The cells' counts at their published widths (TFLOP a step)."""
    import json
    from pathlib import Path

    home = Path(__file__).resolve().parents[1] / "configs"
    pre = json.loads((home / "egovlpv2_pretrain_egoclip.json").read_text())
    ft = json.loads((home / "egovlpv2_ft_charades.json").read_text())
    assert flops.pretrain(pre, 64)["useful"] == pytest.approx(96.68e12,
                                                             rel=1e-3)
    assert flops.dual(ft, 8)["useful"] == pytest.approx(35.63e12, rel=1e-3)
