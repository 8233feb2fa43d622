"""The port's command line against the JAX CLI's on what they share: the
epoch cap of `pretrain` (`max_samples_per_epoch`), the default steps of the
fine-tunes, and every flag of the JAX parsers of the training commands (but
the multi-host ones), which the port's parser takes with the JAX parser's
default and value."""

import argparse
import json
from unittest import mock

import pytest
import torch

from egovlpv2_tpu import cli as jcli
from egovlpv2_torch import cli
from tests.test_cli import TINY

torch.set_num_threads(2)

MULTI_HOST = {"--multihost", "--coordinator", "--num_processes",
              "--process_id"}


class _Parsed(Exception):
    pass


def _jax_parser() -> argparse.ArgumentParser:
    """The parser `egovlpv2_tpu.cli.main` builds, caught as it parses."""
    caught = []

    def catch(parser, *args, **kwargs):
        caught.append(parser)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        with pytest.raises(_Parsed):
            jcli.main([])
    return caught[0]


def _subparsers(parser) -> dict:
    return parser._subparsers._group_actions[0].choices


JAX_PARSER = _jax_parser()
JAX_FLAGS = [(command, action.option_strings[-1])
             for command in ("pretrain", "ft-charades", "ft-epic")
             for action in _subparsers(JAX_PARSER)[command]._actions
             if action.option_strings and action.dest != "help"
             and action.option_strings[-1] not in MULTI_HOST]


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


def test_the_training_commands_take_every_flag_of_the_jax_parsers():
    assert len(JAX_FLAGS) == 65  # 23 of pretrain, 21 of each fine-tune


@pytest.mark.parametrize("command, flag", JAX_FLAGS)
def test_jax_flag_parses_alike(command, flag):
    """The port's parser takes the flag, with the JAX parser's default and,
    given a value, the same value; it names no ROADMAP item any more."""
    action = next(a for a in _subparsers(JAX_PARSER)[command]._actions
                  if flag in a.option_strings)
    if action.nargs == 0:
        argv = [flag]
    elif action.nargs == "*":
        argv = [flag, "model.remat=true", "seed=3"]
    else:
        argv = [flag, {int: "3", float: "0.5"}.get(action.type, "x")]
    port = cli._parser()
    for extra in ([], argv):
        got = vars(port.parse_args([command, *extra]))
        want = vars(JAX_PARSER.parse_args([command, *extra]))
        assert got[action.dest] == want[action.dest], extra
    assert "ROADMAP" not in (port._subparsers._group_actions[0]
                             .choices[command].format_help())
