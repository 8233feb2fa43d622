"""The port's training loop (`egovlpv2_torch/cli.py::_fit`) on the CPU at
the tiny widths of the JAX CLI's tests: `--save_dir`, `--resume`,
`--ckpt_every`, the per-epoch EgoMCQ validation, `--init_val`, the monitor
and early stop, the SIGTERM save, `--ckpt <directory>` and `--visualize`.
The JAX CLI's own tests of these (`tests/test_cli.py`, `tests/test_preemption.py`)
are ported here, and a resumed run is held to the run that did not stop,
bit for bit."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from egovlpv2_torch import cli
from egovlpv2_torch.parallel.distributed import PreemptionGuard
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.train.checkpoint import CheckpointManager
from tests.test_cli import TINY

torch.set_num_threads(2)

VAL = ["--val_synthetic", "--val_batches", "1"]


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.fixture()
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _stats(save):
    return [json.loads(line) for line in
            (save / "stats.txt").read_text().strip().splitlines()]


def _read(path):
    return json.loads(path.read_text())


def test_pretrain_with_val_monitor_and_early_stop(tiny_config, tmp_path):
    """`tests/test_cli.py:44`: three epochs of two steps, a validation after
    each, the monitor's best pointer and state beside the checkpoints, and
    the early stop after an epoch without a better score."""
    save = tmp_path / "run"
    res = cli.main([
        "pretrain", "--config", tiny_config, "--synthetic", "--device", "cpu",
        "--epochs", "3", "--steps_per_epoch", "2", "--save_dir", str(save),
        *VAL, "--val_vtc_only", "--monitor", "max:vtc/Inter-video",
        "--early_stop", "1"])
    assert (save / "ckpt" / "best_step.json").exists()
    assert any("val_vtc/Inter-video" in row for row in _stats(save))
    mon = _read(save / "ckpt" / "monitor.json")
    assert mon["key"] == "vtc/Inter-video" and mon["best"] is not None
    # each validation draws its own epoch's batches, so the score moves;
    # the run stops after the first epoch that does not beat the best
    scores = [v["vtc/Inter-video"] for v in res["val"]]
    stopped = [i for i in range(1, len(scores)) if scores[i] <= max(scores[:i])]
    assert len(scores) == (stopped[0] + 1 if stopped else 3)
    if stopped:
        assert "early stop at epoch" in (save / "info.log").read_text()
    assert {"config.json", "info.log", "stats.txt", "ckpt"} <= set(
        os.listdir(save))
    best = _read(save / "ckpt" / "best_step.json")["step"]
    assert _read(save / "ckpt" / f"metrics_{best}.json")[
        "vtc/Inter-video"] == mon["best"] == max(scores)


def test_pretrain_init_val_eval_mode(tiny_config, tmp_path):
    """`tests/test_cli.py:77`: --init_val --epochs 0 is the reference's
    eval mode: no step, one validation, recorded."""
    save = tmp_path / "run_init_val"
    res = cli.main([
        "pretrain", "--config", tiny_config, "--synthetic", "--device", "cpu",
        "--epochs", "0", "--save_dir", str(save), *VAL, "--val_vtc_only",
        "--init_val"])
    stats = _stats(save)
    assert not any("loss_total" in row for row in stats)
    assert any("val_vtc/Inter-video" in row for row in stats)
    assert res["logged"] == [] and len(res["val"]) == 1
    assert "init val:" in (save / "info.log").read_text()


def test_pretrain_resume_restores_monitor(tiny_config, tmp_path):
    """`tests/test_cli.py:109`: one epoch, then two with --resume: the run
    goes on at epoch 1 from step 2 with the monitor's best."""
    save = tmp_path / "run_resume"
    common = ["pretrain", "--config", tiny_config, "--synthetic", "--device",
              "cpu", "--steps_per_epoch", "2", "--save_dir", str(save), *VAL,
              "--val_vtc_only", "--monitor", "max:vtc/Inter-video",
              "--ckpt_every", "100"]
    cli.main(common + ["--epochs", "1"])
    first = _read(save / "ckpt" / "monitor.json")
    assert _read(save / "ckpt" / "progress.json")["epoch"] == 0
    res = cli.main(common + ["--epochs", "2", "--resume"])
    log_text = (save / "info.log").read_text()
    assert "restored monitor" in log_text
    assert "resumed from step 2 (epoch 1)" in log_text
    assert [r["step"] for r in res["logged"]] == [3, 4]
    second = _read(save / "ckpt" / "monitor.json")
    assert second["best"] >= first["best"]
    assert _read(save / "ckpt" / "progress.json")["epoch"] == 1
    # a run that has finished its epochs resumes to no step at all
    again = cli.main(common + ["--epochs", "2", "--resume"])
    assert again["logged"] == [] and len(again["restore_seconds"]) == 1


def test_pretrain_saves_every_ckpt_every_steps(tiny_config, tmp_path):
    save = tmp_path / "run_every"
    res = cli.main(["pretrain", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--steps_per_epoch", "3",
                    "--ckpt_every", "2", "--save_dir", str(save)])
    ckpt = CheckpointManager(str(save / "ckpt"))
    assert ckpt.all_steps() == [2, 3] and len(res["save_seconds"]) == 2
    assert _read(save / "ckpt" / "progress.json") == {"epoch": 0, "step": 3}


def _same(a, b, where=""):
    """Equal bit for bit: tensors, and containers of them."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), where
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("command", ["pretrain", "ft-charades"])
def test_resumed_run_equals_the_run_that_did_not_stop(tiny_config, tmp_path,
                                                      command):
    """Two epochs in one run, against one epoch, saved, and a second run
    that resumes for the second: the losses of steps 3-4, the validation
    after epoch 1 (pretrain) and the saved state at step 4 (parameters,
    AdamW's moments and steps, the scheduler, the dropout generator) are
    the same bits."""
    common = [command, "--config", tiny_config, "--synthetic", "--device",
              "cpu", "--steps_per_epoch", "2", "--set", "global_batch_size=4"]
    if command == "pretrain":
        common += [*VAL, "--monitor", "max:vtc/Inter-video"]
    whole = cli.main(common + ["--epochs", "2", "--save_dir",
                               str(tmp_path / "whole")])
    cli.main(common + ["--epochs", "1", "--save_dir", str(tmp_path / "cut"),
                       "--init_val"])
    resumed = cli.main(common + ["--epochs", "2", "--save_dir",
                                 str(tmp_path / "cut"), "--resume"])
    assert [r["step"] for r in resumed["logged"]] == [3, 4]
    assert resumed["logged"][0]["loss_total"] != whole["logged"][1][
        "loss_total"]
    for a, b in zip(resumed["logged"], whole["logged"][2:]):
        assert {k: v for k, v in a.items() if k != "step_ms"} == \
            {k: v for k, v in b.items() if k != "step_ms"}
    if command == "pretrain":
        assert resumed["val"] == whole["val"][1:]
        # the raw VTC/VTM scores, not only the accuracies they give
        _same(resumed["val_scores"], whole["val_scores"][1:])
        for scores in whole["val_scores"]:
            assert set(scores) == {"vtc", "vtm"}
            assert all(np.isfinite(v).all() for v in scores.values())
    states = [CheckpointManager(str(tmp_path / d / "ckpt")).restore(4)
              for d in ("whole", "cut")]
    _same(states[0], states[1])
    assert states[0]["generator"] is not None
    assert states[0]["optimizer"]["state"], "AdamW kept no moments"
    fresh = torch.Generator().manual_seed(1).get_state()
    assert not torch.equal(states[0]["generator"], fresh)  # it drew


def test_pretrain_validation_leaves_the_generator_and_train_mode(tiny_config):
    """The validation inside a run runs the model in eval(): dropout draws
    nothing from the step's generator, and the step finds the model in
    train() again."""
    cfg = cli.load_train_config(tiny_config, [])
    model, _, _, step = tpretrain.build_pretrain(cfg, device="cpu")
    args = cli._parser().parse_args(["pretrain", "--synthetic", *VAL])
    validate = cli._egomcq_validation(args, cfg, model)
    assert model.training and cfg.model.video.drop_path_rate + \
        cfg.model.text.hidden_dropout > 0
    before = step.generator.get_state()
    first, record = validate(0)
    scores = cli._record_scores(record)
    assert model.training
    assert torch.equal(step.generator.get_state(), before)
    model.eval()
    again, record = validate(0)  # the same scores as a model in eval()
    assert again == first
    _same(cli._record_scores(record), scores)
    assert not model.training  # the mode it was given is put back
    assert cli._egomcq_validation(
        cli._parser().parse_args(["pretrain", "--synthetic"]), cfg,
        model) is None


def test_pretrain_sigterm_saves_and_exits(tiny_config, tmp_path, monkeypatch):
    """`tests/test_preemption.py:37` in one process: SIGTERM arrives while
    the batch of step 4 is drawn; the step ends, the loop saves with the
    epoch marked unfinished, logs, puts the handler back and returns."""
    save = tmp_path / "run"
    calls = []
    draw = tpretrain.synthetic_batch

    def batch_then_sigterm(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            handler = signal.getsignal(signal.SIGTERM)
            # the guard's handler must be in place, or the signal would
            # end this test's process
            assert isinstance(getattr(handler, "__self__", None),
                              PreemptionGuard), handler
            os.kill(os.getpid(), signal.SIGTERM)
        return draw(*a, **kw)

    monkeypatch.setattr(tpretrain, "synthetic_batch", batch_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    res = cli.main(["pretrain", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--steps_per_epoch", "100000",
                    "--epochs", "1", "--save_dir", str(save)])
    assert signal.getsignal(signal.SIGTERM) == before
    assert res["preempted"] and [r["step"] for r in res["logged"]] == \
        [1, 2, 3, 4]
    log_text = (save / "info.log").read_text()
    assert "preempted (SIGTERM): saved at step 4, exiting" in log_text
    assert "done at step" not in log_text
    # the epoch is unfinished: a resumed run replays it
    assert _read(save / "ckpt" / "progress.json") == {"epoch": -1, "step": 4}
    assert CheckpointManager(str(save / "ckpt")).all_steps() == [4]


def test_sigterm_save_skips_a_step_just_saved(tiny_config, tmp_path,
                                              monkeypatch):
    """With --ckpt_every the periodic save of the step in flight stands in
    for the SIGTERM save (the JAX CLI's `latest_step() != step`)."""
    save = tmp_path / "run"
    monkeypatch.setattr(PreemptionGuard, "preempted", property(
        lambda self: True))
    res = cli.main(["pretrain", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--steps_per_epoch", "5",
                    "--ckpt_every", "1", "--save_dir", str(save)])
    assert res["preempted"] and len(res["logged"]) == 1
    assert len(res["save_seconds"]) == 1
    assert not (save / "ckpt" / "progress.json").exists()


def test_egomcq_restores_a_checkpoint_directory(tiny_config, tmp_path):
    """`tests/test_cli.py:141`: `egomcq --ckpt <save_dir>/ckpt` evaluates
    the parameters of the best step, exactly."""
    save = tmp_path / "run2"
    cli.main(["pretrain", "--config", tiny_config, "--synthetic", "--device",
              "cpu", "--epochs", "2", "--steps_per_epoch", "1",
              "--save_dir", str(save), *VAL, "--val_vtc_only",
              "--monitor", "min:vtc/Inter-video"])
    ckpt = CheckpointManager(str(save / "ckpt"))
    best = ckpt.best_step()
    assert best is not None and ckpt.all_steps() == [1, 2]
    out = tmp_path / "m.json"
    res = cli.main(["egomcq", "--config", tiny_config, "--device", "cpu",
                    "--ckpt", str(save / "ckpt"), "--batch_size", "2",
                    "--val_batches", "1", "--vtc_only", "--out", str(out)])
    assert "vtc/" in next(iter(_read(out)))
    saved = ckpt.restore(best)["model"]
    got = res["model"].state_dict()
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k


def test_dual_finetune_resume(tiny_config, tmp_path):
    """`tests/test_cli.py:215`: the fine-tunes resume with the optimizer's
    state and the epoch, as pretrain does."""
    save = tmp_path / "ft"
    common = ["ft-charades", "--config", tiny_config, "--synthetic",
              "--device", "cpu", "--steps_per_epoch", "2", "--save_dir",
              str(save), "--set", "global_batch_size=4"]
    cli.main(common + ["--epochs", "1"])
    assert _read(save / "ckpt" / "progress.json")["epoch"] == 0
    res = cli.main(common + ["--epochs", "2", "--resume"])
    assert "resumed from step 2 (epoch 1)" in (save / "info.log").read_text()
    assert _read(save / "ckpt" / "progress.json")["epoch"] == 1
    assert [r["step"] for r in res["logged"]] == [3, 4]
    assert _read(save / "config.json")["model"]["projection"] == "small"


def test_ckpt_directory_into_finetune_and_taskqa(tiny_config, tmp_path,
                                                 monkeypatch):
    """A pretrain run's directory as `--ckpt` of a dual fine-tune (no ITM or
    MLM head, its own small projections) and of `taskqa` (the backbone):
    each takes the parameters it has, exactly."""
    save = tmp_path / "pre"
    cli.main(["pretrain", "--config", tiny_config, "--synthetic", "--device",
              "cpu", "--steps_per_epoch", "1", "--save_dir", str(save)])
    saved = CheckpointManager(str(save / "ckpt")).restore()["model"]
    res = cli.main(["ft-charades", "--config", tiny_config, "--synthetic",
                    "--device", "cpu", "--epochs", "0", "--ckpt",
                    str(save / "ckpt")])
    got = res["model"].state_dict()
    own = {k for k in got if k.startswith(("txt_proj.", "vid_proj."))}
    assert own and not any(k.startswith(("itm_score", "mlm_score"))
                           for k in got)
    for k, v in got.items():
        if k not in own:
            assert torch.equal(v, saved[k]), k

    from egovlpv2_torch.tasks import orchestrators

    seen = {}

    def fake_run(model_cfg, train, val, num_answers, **kw):
        seen.update(kw["backbone_state_dict"])
        return {"acc": 0.0}

    monkeypatch.setattr(orchestrators, "run_egotaskqa", fake_run)
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps([{"interval": "iv0", "question": "q",
                               "answer_encode": 0, "type": "causal"}]))
    answers = tmp_path / "answers.txt"
    answers.write_text("yes\nno\n")
    cli.main(["taskqa", "--config", tiny_config, "--device", "cpu",
              "--qa_train", str(qa), "--qa_val", str(qa), "--videos",
              str(tmp_path), "--answer_set", str(answers), "--ckpt",
              str(save / "ckpt")])
    assert set(seen) == set(saved)
    for k, v in saved.items():
        assert torch.equal(seen[k], v), k


def test_ckpt_directory_without_a_checkpoint_raises(tiny_config, tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "progress.json").write_text("{}")
    for d in ("empty", "other"):
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            cli.main(["egomcq", "--config", tiny_config, "--device", "cpu",
                      "--ckpt", str(tmp_path / d)])
    # a fine-tune's directory lacks the heads of an EgoMCQ model
    cli.main(["ft-epic", "--config", tiny_config, "--synthetic", "--device",
              "cpu", "--steps_per_epoch", "1", "--set", "global_batch_size=2",
              "--save_dir", str(tmp_path / "ft")])
    with pytest.raises(KeyError, match="lacks"):
        cli.main(["egomcq", "--config", tiny_config, "--device", "cpu",
                  "--ckpt", str(tmp_path / "ft" / "ckpt")])


def test_visualize_writes_the_epic_validation(tiny_config, tmp_path):
    """--visualize: each EK-100 validation, --init_val's too, writes a page
    of its queries' top retrievals under save_dir/web and links it from
    index.html; without it, no web/."""
    from tests.test_torch_cli_files import _epic_files

    data, meta = _epic_files(tmp_path)
    base = ["ft-epic", "--config", tiny_config, "--device", "cpu", "--meta",
            str(meta), "--data", str(data), "--val_meta", str(meta),
            "--val_batch_size", "4", "--set", "global_batch_size=8",
            "--num_workers", "2"]
    save = tmp_path / "viz"
    res = cli.main(base + ["--save_dir", str(save), "--visualize",
                           "--init_val"])
    assert len(res["val"]) == 2
    web = save / "web"
    assert sorted(os.listdir(web)) == ["index.html", "retrieval_epoch0.html",
                                       "retrieval_epoch1.html"]
    page = (web / "retrieval_epoch1.html").read_text()
    assert page.count("<tr class=") == 8 and "cut thing 3" in page
    assert 'href="retrieval_epoch1.html"' in (web / "index.html").read_text()
    plain = tmp_path / "plain"
    cli.main(base + ["--save_dir", str(plain), "--epochs", "0",
                     "--init_val"])
    assert not (plain / "web").exists()
    assert np.isfinite(list(res["val"][1].values())).all()


def test_pretrain_on_files_validates_on_synthetic_batches(tiny_config,
                                                          tmp_path):
    """--val_synthetic beside --meta: the validation draws synthetic EgoMCQ
    batches; pretrain's --meta names EgoClip's files, never EgoMCQ's."""
    from tests.test_torch_cli_files import _egoclip

    data, _, meta = _egoclip(tmp_path)
    res = cli.main(["pretrain", "--config", tiny_config, "--device", "cpu",
                    "--meta", str(meta), "--data", str(data),
                    "--num_workers", "2", "--set", "global_batch_size=8",
                    "--val_synthetic", "--val_batches", "2", "--init_val"])
    assert len(res["logged"]) == 2 and len(res["val"]) == 2
    assert all(set(v) >= {"vtc/Inter-video", "vtm/Inter-video"}
               for v in res["val"])
