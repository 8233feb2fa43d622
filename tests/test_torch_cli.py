"""The port's command line against the JAX CLI's on what they share: the
epoch cap of `pretrain` (`max_samples_per_epoch`), the default steps of the
fine-tunes, and every flag of the JAX parsers (but the multi-host ones),
which parses and, where the port does not implement it yet, raises the
NotImplementedError that names its ROADMAP item."""

import json

import pytest
import torch

from egovlpv2_torch import cli
from tests.test_cli import TINY

torch.set_num_threads(2)

NOT_PORTED = [(command, flag) for command, flags in cli._NOT_PORTED.items()
              for flag in flags]
BASE = {"pretrain": ["pretrain", "--synthetic"], "egomcq": ["egomcq"],
        "ft": ["ft-charades", "--synthetic"]}


@pytest.fixture()
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def test_pretrain_max_samples_per_epoch_caps_steps(tiny_config):
    """max_samples_per_epoch breaks the epoch early (trainer_egoclip.py:108;
    `egovlpv2_tpu/cli.py:387-401`): 16 samples at batch 8 are 2 steps an
    epoch, not --steps_per_epoch 10."""
    res = cli.main(["pretrain", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--epochs", "2", "--steps_per_epoch",
                    "10", "--set", "global_batch_size=8",
                    "max_samples_per_epoch=16"])
    assert [(r["epoch"], r["step"]) for r in res["logged"]] == \
        [(0, 1), (0, 2), (1, 3), (1, 4)]
    res = cli.main(["pretrain", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--steps_per_epoch", "1", "--set",
                    "global_batch_size=8", "max_samples_per_epoch=4"])
    assert len(res["logged"]) == 1  # at least one step, below one batch too


def test_finetune_runs_four_steps_an_epoch_by_default(tiny_config, monkeypatch):
    """`ft-charades` / `ft-epic` default to 4 steps an epoch, as the JAX
    CLI's (`egovlpv2_tpu/cli.py:1062`)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    res = cli.main(["ft-epic", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--set", "global_batch_size=2"])
    assert [r["step"] for r in res["logged"]] == [1, 2, 3, 4]


@pytest.mark.parametrize("command, flag", NOT_PORTED)
def test_not_ported_flags_parse_then_name_their_item(command, flag):
    switch, needs = cli._NOT_PORTED[command][flag]
    item = needs.split("ROADMAP.md ")[1].split(",")[0]
    args = BASE[command] + ["--device", "cpu", flag] + ([] if switch else ["1"])
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}") as err:
        cli.main(args)
    assert str(err.value).startswith(flag)
