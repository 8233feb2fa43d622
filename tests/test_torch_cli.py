"""The port's command line against the JAX CLI's on what they share: the
epoch cap of `pretrain` (`max_samples_per_epoch`), the default steps of the
fine-tunes, every flag of the JAX parsers of the training commands and of
the downstream heads' `mq`, `mq-anno`, `nlq` and `qfvs`, the multi-host
ones among them, which the port's parser takes with the JAX parser's
default and value; and the four heads' commands on the CPU on files
written here, as `tests/test_cli_downstream.py` runs the JAX ones."""

import argparse
import json
from unittest import mock

import numpy as np
import pytest
import scipy.io
import torch

from egovlpv2_tpu import cli as jcli
from egovlpv2_torch import cli
from tests.test_cli import TINY

torch.set_num_threads(2)

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
COMMANDS = ("pretrain", "ft-charades", "ft-epic", "mq", "mq-anno", "nlq",
            "qfvs")
JAX_FLAGS = [(command, action.option_strings[-1])
             for command in COMMANDS
             for action in _subparsers(JAX_PARSER)[command]._actions
             if action.option_strings and action.dest != "help"]


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
    # 27 of pretrain, 25 of each fine-tune (the four multi-host flags
    # among them); mq 14, mq-anno 4, nlq 9, qfvs 12
    assert len(JAX_FLAGS) == 116


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
    # the command's required flags, each with a value
    required = [arg for a in _subparsers(JAX_PARSER)[command]._actions
                if a.required for arg in (a.option_strings[-1], "x")]
    port = cli._parser()
    for extra in ([], argv):
        got = vars(port.parse_args([command, *required, *extra]))
        want = vars(JAX_PARSER.parse_args([command, *required, *extra]))
        assert got[action.dest] == want[action.dest], extra
    assert "ROADMAP" not in (port._subparsers._group_actions[0]
                             .choices[command].format_help())


def test_the_port_has_every_command_of_the_jax_cli():
    """Every subcommand of the JAX parser is one of the port's (`bench`
    the last to come)."""
    jax_commands = set(_subparsers(JAX_PARSER))
    assert "bench" in jax_commands
    assert jax_commands <= set(_subparsers(cli._parser()))


@pytest.mark.parametrize("command", sorted(_subparsers(cli._parser())))
def test_every_command_names_its_device(command):
    """`main` starts a multi-host group on the command's device: the card,
    but for mq-anno, which touches none."""
    port = cli._parser()
    required = [arg for a in _subparsers(port)[command]._actions
                if a.required for arg in (a.option_strings[-1], "1")]
    args = port.parse_args([command, *required])
    assert args.device == ("cpu" if command == "mq-anno" else "cuda")


# ---------------- the downstream heads' commands ----------------


def _mq_files(tmp_path):
    """Ego4D moments and video info jsons and [40, 8] clip features: two
    train clips and one val, two moments each."""
    rs = np.random.RandomState(2)
    videos = []
    for split, names in (("train", ["a", "b"]), ("val", ["c"])):
        for name in names:
            np.save(tmp_path / f"{name}.npy",
                    rs.randn(40, 8).astype(np.float32))
            videos.append({
                "video_uid": f"vid_{name}", "split": split,
                "clips": [{
                    "clip_uid": name,
                    "video_start_sec": 0.0, "video_end_sec": 20.0,
                    "annotations": [{"labels": [
                        {"label": "cook", "primary": True,
                         "start_time": 2.0, "end_time": 6.0},
                        {"label": "clean", "primary": True,
                         "start_time": 10.0, "end_time": 14.0},
                    ]}],
                }],
            })
    moments = tmp_path / "moments.json"
    moments.write_text(json.dumps({"videos": videos}))
    info = tmp_path / "ego4d.json"
    info.write_text(json.dumps({"videos": [
        {"video_uid": v["video_uid"], "duration_sec": 20.0} for v in videos]}))
    return str(moments), str(info)


def test_cli_mq_anno_then_mq(tmp_path, capsys):
    """mq-anno writes the clip table from the moments jsons, mq trains
    VSGN on it (T = 64, 3 levels), prints and writes the metrics and
    writes the challenge files; without --device it asks for the card."""
    moments, info = _mq_files(tmp_path)
    anno = tmp_path / "clip_annotations.json"
    counts = cli.main(["mq-anno", "--moments", moments, "--info", info,
                       "--features", str(tmp_path), "--out", str(anno)])
    assert counts == {"train": 2, "val": 1}
    assert set(json.loads(anno.read_text())) == {"a", "b", "c"}
    out = tmp_path / "mq_metrics.json"
    argv = ["mq", "--anno", str(anno), "--features", str(tmp_path),
            "--out", str(tmp_path / "mq_out"), "--epochs", "1",
            "--batch_size", "2", "--temporal_scale", "64",
            "--input_feat_dim", "8", "--num_levels", "3",
            "--metrics_out", str(out)]
    res = cli.main(argv + ["--device", "cpu"])
    metrics = json.loads(out.read_text())
    assert 0.0 <= metrics["mAP_avg"] <= 1.0 and "recall@1x_tiou0.3" in metrics
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == metrics == res["metrics"]
    assert len(res["timings"]["step"]) == 1
    for name in ("submission.json", "detections_postNMS.json",
                 "retreival_postNMS.json"):
        assert (tmp_path / "mq_out" / name).exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


def test_cli_nlq(tmp_path):
    rs = np.random.RandomState(1)
    videos = []
    for i in range(8):
        clip_uid = f"clip{i}"
        np.save(tmp_path / f"{clip_uid}_ann{i}_0.npy",
                rs.randn(20, 12).astype(np.float32))
        np.save(tmp_path / f"{clip_uid}_ann{i}_0_query.npy",
                rs.randn(5, 12).astype(np.float32))
        videos.append({"video_uid": f"vid{i}", "clips": [{
            "clip_uid": clip_uid, "video_start_sec": 0.0,
            "video_end_sec": 20.0, "annotations": [{
                "annotation_uid": f"ann{i}", "language_queries": [{
                    "query": f"where is object {i}",
                    "clip_start_sec": 3.0, "clip_end_sec": 9.0}]}]}]})
    train_anno = tmp_path / "nlq_train.json"
    val_anno = tmp_path / "nlq_val.json"
    train_anno.write_text(json.dumps({"videos": videos[:6]}))
    val_anno.write_text(json.dumps({"videos": videos[6:]}))
    out = tmp_path / "nlq_metrics.json"
    res = cli.main(["nlq", "--train_anno", str(train_anno), "--val_anno",
                    str(val_anno), "--features", str(tmp_path), "--epochs",
                    "1", "--batch_size", "2", "--max_pos_len", "24",
                    "--video_feature_dim", "12", "--metrics_out", str(out),
                    "--device", "cpu"])
    metrics = json.loads(out.read_text())
    for k in ("R1@0.3", "R5@0.5", "mIoU"):
        assert k in metrics and 0.0 <= metrics[k] <= 100.0
    assert len(res["timings"]["step"]) == 3 and len(res["timings"]["infer"]) == 2


def test_cli_qfvs(tmp_path):
    rs = np.random.RandomState(3)
    for vid in (1, 2):
        od = tmp_path / "oracle" / f"P0{vid}"
        td = tmp_path / "tags" / f"P0{vid}"
        od.mkdir(parents=True)
        td.mkdir(parents=True)
        (od / "Car_Tree_oracle.txt").write_text("1\n3\n")
        (td / f"P0{vid}.txt").write_text("Car,Sky\nTree\nCar,Tree\nSky\n")
        np.savez(tmp_path / f"P0{vid}.npz",
                 seg_len=np.array([3, 1] + [0] * 6),
                 feat_concept1=rs.randn(8, 4, 16).astype(np.float32),
                 feat_concept2=rs.randn(8, 4, 16).astype(np.float32),
                 feat_oracle=rs.randn(8, 4, 16).astype(np.float32))
    cell = np.empty((2, 1), object)
    for i in range(2):
        cell[i, 0] = (rs.rand(4, 3) > 0.5).astype(np.uint8)
    scipy.io.savemat(tmp_path / "Tags.mat", {"Tags": cell})
    out = tmp_path / "qfvs_metrics.json"
    res = cli.main(["qfvs", "--oracle", str(tmp_path / "oracle"), "--tags",
                    str(tmp_path / "tags"), "--tags_mat",
                    str(tmp_path / "Tags.mat"), "--features", str(tmp_path),
                    "--train_videos", "1", "--test_video", "2", "--epochs",
                    "1", "--max_segments", "8", "--max_shots", "4",
                    "--metrics_out", str(out), "--device", "cpu"])
    metrics = json.loads(out.read_text())
    assert set(metrics) == {"F1"} and np.isfinite(metrics["F1"])
    assert res["metrics"] == metrics and len(res["timings"]["step"]) == 1
