"""The step's operation count against PyTorch's FlopCounterMode over the
port's own step at tiny widths on the CPU, where every attention is plain
matrix products; the step's table of hand-kernel calls against the calls
the benchmark's ranges record over the same step."""

import dataclasses
import json
import tempfile
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import bounds, flops, trace
from perfbench.tests.tiny import tiny_config


def tiny_step(task: str, dtype: str, rows: int, attn_dropout: float = 0.1):
    """The port's step of `task` on the CPU at tiny widths, run once, with
    its configuration (as the program and as the file's dict) and a batch
    of `rows` rows."""
    from egovlpv2_torch.core.config import load_train_config
    from egovlpv2_torch.tasks.pretrain import build_pretrain, synthetic_batch
    from egovlpv2_torch.tasks.retrieval import build_dual

    cfg_dict = tiny_config(task, dtype)
    cfg_dict["model"]["text"]["attn_dropout"] = attn_dropout
    build = build_pretrain if task == "pretrain" else build_dual
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump({k: v for k, v in cfg_dict.items()
                   if not k.startswith("_")}, f)
        f.flush()
        cfg = load_train_config(f.name)
    torch.manual_seed(0)
    _, _, _, step = build(cfg, "cpu")
    batch = synthetic_batch(cfg, rows, np.random.default_rng(0))
    step(batch)
    return step, batch, cfg, cfg_dict


@pytest.mark.parametrize("task", ["pretrain", "dual"])
def test_count_matches_flop_counter(task):
    rows = 6
    step, batch, cfg, cfg_dict = tiny_step(task, "float32", rows)
    with FlopCounterMode(display=False) as counter:
        step(batch)
    counted = (flops.pretrain(cfg_dict, rows) if task == "pretrain"
               else flops.dual(cfg_dict, rows))
    assert counted["useful"] + counted["recomputed"] \
        == counter.get_total_flops()
    assert dataclasses.asdict(cfg)["model"] == cfg_dict["model"]


@pytest.mark.parametrize("attn_dropout", [0.1, 0.0],
                         ids=["text_dropout", "text_k9"])
@pytest.mark.parametrize("task", ["pretrain", "dual"])
def test_call_table_matches_the_recorded_calls(task, attn_dropout):
    """Every call of the divided attention, of LayerNorm and of the fused
    attention (K9) that the step makes, with its shape and whether it took
    a backward, is the table's (`bounds.pretrain_calls`,
    `bounds.dual_calls`), as a multiset; with the text's attention dropout
    at 0 the text's attentions run K9 too."""
    rows = 6
    step, batch, _, cfg_dict = tiny_step(task, "bfloat16", rows,
                                         attn_dropout)
    with trace.Instrument():
        tr = trace.profile(lambda: step(batch), cuda=False)
    recorded = Counter((r.name, bool(tr.backward_of(r)))
                       for op in ("divided_attn", "layernorm", "fused_attn")
                       for r in tr.named(f"perfbench.{op}|"))
    table = (bounds.pretrain_calls if task == "pretrain"
             else bounds.dual_calls)(cfg_dict, rows)
    assert recorded == Counter((trace.call_name(c.op, **dict(c.shape)),
                                c.backward) for c in table)
    # the table has calls with and without a backward (pretrain's MLM path)
    assert {c.backward for c in table} == (
        {True, False} if task == "pretrain" else {True})
    fused = [c for c in table if c.op == "fused_attn"]
    z = flops.Shapes(cfg_dict, rows)
    # EgoNCE's text tower; each fused path's text layers and t2i's
    text = (z.layers + 2 * (z.layers + z.fuse) if task == "pretrain"
            else z.layers) if attn_dropout == 0 else 0
    i2t = 2 * z.fuse if task == "pretrain" else 0
    assert len(fused) == text + i2t


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


def test_full_width_k9_calls():
    """The pretrain cell's step runs K9 for the fused video blocks' i2t
    alone: 6 blocks on each of MLM's and ITM's paths, 12 a step, all but
    MLM's last block with a backward; the text attends with dropout."""
    from pathlib import Path

    home = Path(__file__).resolve().parents[1] / "configs"
    pre = json.loads((home / "egovlpv2_pretrain_egoclip.json").read_text())
    fused = [c for c in bounds.pretrain_calls(pre, 64)
             if c.op == "fused_attn"]
    assert len(fused) == 12 and sum(c.backward for c in fused) == 11
    assert {dict(c.shape)["sq"] for c in fused} == {785}
    assert {dict(c.shape)["sk"] for c in fused} == {15}
    ft = json.loads((home / "egovlpv2_ft_charades.json").read_text())
    assert not [c for c in bounds.dual_calls(ft, 8) if c.op == "fused_attn"]
