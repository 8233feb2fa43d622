"""The EgoTaskQA slice of egovlpv2_torch against egovlpv2_tpu on the CPU,
f32: the QA model's logits, loss and every gradient from the same
parameters (through the weight bridge, both ways); three steps of the
one-group AdamW against optax; `evaluate_qa` and `ReasoningTypeAccuracy`;
the checkpoint manager (a restored run steps on bit for bit, dropout on);
the data copies the dataset reads with (sampling, transforms, readers,
`default_collate`, `DataLoader`, `EgoTaskQADataset`) array for array on
videos OpenCV writes; and `cli taskqa` end to end on such files."""

import dataclasses
import json

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.data import loader as jloader
from egovlpv2_tpu.data import readers as jreaders
from egovlpv2_tpu.data import sampling as jsampling
from egovlpv2_tpu.data import transforms as jtransforms
from egovlpv2_tpu.downstream import datasets as jdatasets
from egovlpv2_tpu.downstream import taskqa as jqa
from egovlpv2_tpu.objectives.losses import cross_entropy_loss as jce
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_torch import cli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.data import loader as tloader
from egovlpv2_torch.data import readers as treaders
from egovlpv2_torch.data import sampling as tsampling
from egovlpv2_torch.data import transforms as ttransforms
from egovlpv2_torch.downstream import datasets as tdatasets
from egovlpv2_torch.downstream import taskqa as tqa
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.train import checkpoint as tckpt
from egovlpv2_torch.train import optimizer as topt
from egovlpv2_torch.train.step import batch_to_device
from egovlpv2_torch.weights import (flax_from_state_dict, overlay_,
                                    state_dict_from_flax, training_init_)
from tests.test_cli import TINY, _write_mp4
from torch_parity import perturb

torch.set_num_threads(2)
BATCH, TEXT_LEN, ANSWERS = 4, 12, 5


def _configs(dropout=0.0):
    """The tiny model of both packages (4 video blocks and 4 text layers,
    the last 2 of each fused), the XLA attention path on the JAX side."""
    out = []
    for mod, pre in ((jconfig, jpretrain), (tconfig, tpretrain)):
        cfg = pre.tiny_train_config()
        text = mod.replace(cfg.model.text, hidden_dropout=dropout,
                           attn_dropout=dropout)
        out.append(mod.replace(cfg.model, text=text, remat=False,
                               attn_impl="xla"))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _batch(cfg, seed):
    """A QA batch with padded questions of random lengths."""
    rs = np.random.RandomState(seed)
    v = cfg.video
    ids = rs.randint(4, cfg.text.vocab_size - 2, (BATCH, TEXT_LEN))
    ids[:, 0] = 0
    mask = np.ones((BATCH, TEXT_LEN), np.int32)
    for i, n in enumerate(rs.randint(4, TEXT_LEN + 1, BATCH)):
        ids[i, n - 1], ids[i, n:], mask[i, n:] = 2, 1, 0
    return {"video": rs.randn(BATCH, v.num_frames, v.img_size, v.img_size,
                              v.in_chans).astype(np.float32),
            "text_ids": ids.astype(np.int32), "text_mask": mask,
            "answer": rs.randint(0, ANSWERS, BATCH).astype(np.int32)}


def _flax_qa(jcfg, batch, seed=0):
    jmodel = jqa.make_qa_model(jcfg, ANSWERS)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["video"][:1]),
                         jnp.asarray(batch["text_ids"][:1]),
                         jnp.asarray(batch["text_mask"][:1]))["params"]
    return jmodel, perturb(params, seed=seed)


def _torch_qa(tcfg, params):
    """Strict: the bridge maps the QA model's tree name for name."""
    model = tqa.make_qa_model(tcfg, ANSWERS)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.qa_head.dropout.rate = 0.0  # JAX below runs deterministic
    return model.train()


def _jloss(jmodel, batch):
    """The JAX loss of `qa_loss_fn` without dropout (deterministic)."""
    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(batch["video"]),
                              jnp.asarray(batch["text_ids"]),
                              jnp.asarray(batch["text_mask"]))
        return jce(logits, jnp.asarray(batch["answer"])), logits
    return loss


def test_qa_logits_loss_and_every_gradient_match_jax():
    """Logits and loss within 1e-4 of max |reference|; a gradient within
    1e-4 of max |reference| of its tensor (f32 sums in another order); a
    tensor whose largest gradient is below 1e-2 to 1e-6 absolute. The
    bridge carries the QA tree both ways."""
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, 1)
    jmodel, params = _flax_qa(jcfg, batch)
    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
        _jloss(jmodel, batch), has_aux=True)(params)

    model = _torch_qa(tcfg, params)
    assert set(params) == {"backbone", "qa_head"}
    assert set(params["qa_head"]) == {"projector_1", "projector_2"}
    back = flax_from_state_dict(model.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tb = batch_to_device(batch, torch.device("cpu"))
    logits = model(tb["video"], tb["text_ids"], tb["text_mask"])
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=1e-4 * np.abs(ref_logits).max())
    loss, metrics = tqa.qa_loss_fn(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    acc = np.mean(ref_logits.argmax(-1) == batch["answer"])
    assert metrics["acc"].item() == acc and set(metrics) == {"loss_total", "acc"}
    ref = state_dict_from_flax(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        r = ref[name]
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(1e-2, r.abs().max().item())
        np.testing.assert_allclose(grad.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_three_steps_match_optax_adamw():
    """The one-group AdamW and warmup-cosine schedule of `run_egotaskqa`
    (optax.adamw(warmup_cosine_decay_schedule(0, lr, 1, 4), weight_decay
    0.01)) for three steps on three batches: the first update runs at lr 0
    and moves nothing in either package; then parameters within 2e-4
    (times max |param| where that is above 1). An element whose gradient is
    zero but for rounding (the key biases: a softmax over keys does not see
    a shift common to all keys) is stepped by about +-lr on the sign of its
    rounding noise in each package, as eps is 1e-8: such elements (a JAX
    gradient not 0 and below 1e-6 at every step) are held to
    2 (lr_1 + lr_2) = 3.5 lr. An element whose gradient is exactly 0
    (an unused token's embedding) is decayed alike in both."""
    lr, warmup, total = 1e-3, 1, 4
    jcfg, tcfg = _configs()
    batches = [_batch(tcfg, 10 + i) for i in range(3)]
    jmodel, params = _flax_qa(jcfg, batches[0], seed=3)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total),
                     weight_decay=0.01)
    opt_state = tx.init(params)
    model = _torch_qa(tcfg, params)
    optimizer, scheduler = topt.make_adamw_warmup_cosine(model, lr, warmup,
                                                         total)
    assert len(optimizer.param_groups) == 1
    assert optimizer.param_groups[0]["weight_decay"] == 0.01
    step = tqa.make_qa_train_step(model, optimizer, scheduler,
                                  torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    largest = {n: torch.zeros_like(p) for n, p in start.items()}
    for i, batch in enumerate(batches):
        (ref_loss, _), grads = jax.value_and_grad(
            _jloss(jmodel, batch), has_aux=True)(params)
        for n, g in state_dict_from_flax(grads).items():
            largest[n] = torch.maximum(largest[n], g.abs())
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = step(batch)
        np.testing.assert_allclose(metrics["loss_total"].item(),
                                   float(ref_loss), rtol=2e-4, atol=2e-4)
        if i == 0:
            assert all(torch.equal(p, start[n])
                       for n, p in model.named_parameters())
    ref = state_dict_from_flax(params)
    noise = 0
    for name, p in model.named_parameters():
        scale = max(1.0, ref[name].abs().max().item())
        rounding = (largest[name] > 0) & (largest[name] < 1e-6)
        atol = torch.where(rounding, 3.5 * lr, 2e-4 * scale)
        noise += int(rounding.sum())
        err = (p.detach() - ref[name]).abs()
        assert (err <= atol + 2e-4 * ref[name].abs()).all(), \
            (name, err.max().item())
    assert noise < 0.01 * sum(p.numel() for p in start.values())
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 5e-4 and scheduler.last_epoch == 3
    factor = topt.warmup_cosine_factor(warmup, total)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    for count in range(6):
        np.testing.assert_allclose(factor(count) * lr, float(sched(count)),
                                   rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="decay steps"):
        topt.warmup_cosine_factor(2, 2)


def test_evaluate_qa_and_reasoning_types_match_jax():
    """The same parameters and batches give the same accuracies, overall
    and per reasoning type; and the accumulator on fixed predictions."""
    jcfg, tcfg = _configs()
    batches = [_batch(tcfg, 20 + i) for i in range(2)]
    types = ["causal", "descriptive", "intent"]
    for b, rt in zip(batches, ([["causal"], ["causal", "descriptive"], [],
                                ["intent"]],
                               [["descriptive"], ["causal"], ["intent"],
                                ["causal", "intent"]])):
        b["reasoning_types"] = rt
    jmodel, params = _flax_qa(jcfg, batches[0], seed=5)
    model = _torch_qa(tcfg, params)
    ref = jqa.evaluate_qa(jmodel, params, batches, types)
    got = tqa.evaluate_qa(model, batches, types)
    assert got == ref and not model.training
    assert set(got) == {"acc", "acc/causal", "acc/descriptive", "acc/intent"}
    pred, label = np.array([0, 1, 2, 1, 0]), np.array([0, 2, 2, 1, 1])
    rt = [["a"], ["a", "b"], ["b"], [], ["c", "a"]]
    j, t = jqa.ReasoningTypeAccuracy(["a", "b", "c"]), \
        tqa.ReasoningTypeAccuracy(["a", "b", "c"])
    j.update(rt, pred, label)
    t.update(rt, pred, label)
    assert t.accuracies() == j.accuracies() == {"a": 1 / 3, "b": 0.5, "c": 0.0}


def test_checkpoint_resume_steps_on_bit_for_bit(tmp_path):
    """Four steps straight, against two steps, a save through
    `CheckpointManager`, a restore into fresh objects and two more steps:
    losses and parameters equal bit for bit, with dropout on (text 0.1,
    the QA head 0.2). The manager keeps the newest three and the sidecar
    files of the JAX one."""
    _, tcfg = _configs(dropout=0.1)
    batches = [_batch(tcfg, 30 + i) for i in range(4)]

    def fresh():
        model = tqa.make_qa_model(tcfg, ANSWERS)
        init = torch.Generator().manual_seed(0)
        training_init_(model.backbone, init)
        training_init_(model.qa_head, init)
        optimizer, scheduler = topt.make_adamw_warmup_cosine(model, 1e-3, 1, 4)
        generator = torch.Generator().manual_seed(1)
        return (model, optimizer, scheduler, generator,
                tqa.make_qa_train_step(model, optimizer, scheduler, generator))

    model, opt, sched, gen, step = fresh()
    straight = [step(b)["loss_total"].item() for b in batches]
    end = {n: p.detach().clone() for n, p in model.named_parameters()}

    mngr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    model, opt, sched, gen, step = fresh()
    losses = [step(b)["loss_total"].item() for b in batches[:2]]
    mngr.save(2, tckpt.train_state(model, opt, sched, gen, 2),
              metrics={"loss": losses[-1]}, is_best=True, epoch=0)
    model, opt, sched, gen, step = fresh()
    assert tckpt.load_train_state_(mngr.restore(), model, opt, sched, gen) == 2
    losses += [step(b)["loss_total"].item() for b in batches[2:]]
    assert losses == straight and len(set(straight)) == 4
    for n, p in model.named_parameters():
        assert torch.equal(p, end[n]), n

    assert (mngr.latest_step(), mngr.best_step(), mngr.last_epoch()) == (2, 2, 0)
    assert json.loads((tmp_path / "ckpt" / "metrics_2.json").read_text()) \
        == {"loss": losses[1]}
    state = tckpt.train_state(model, opt, sched, gen, 4)
    for s in (4, 6, 8):
        mngr.save(s, state)
    assert mngr.all_steps() == [4, 6, 8] and mngr.best_step() == 2
    params = mngr.restore_params(prefer_best=False)
    assert all(torch.equal(params[n], p) for n, p in model.state_dict().items())
    mngr.save_monitor({"key": "acc", "best": 0.5, "bad_epochs": 1})
    assert mngr.monitor_state() == {"key": "acc", "best": 0.5, "bad_epochs": 1}
    assert tckpt.CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_qa_backbone_overlay_takes_the_shared_names():
    """`overlay_`: a pretrain model's state_dict onto the QA backbone takes
    every name the two share and leaves the QA head alone."""
    _, tcfg = _configs()
    pre = training_init_(EgoVLPv2(tcfg), torch.Generator().manual_seed(7))
    qa = tqa.make_qa_model(tcfg, ANSWERS)
    head = {k: v.clone() for k, v in qa.qa_head.state_dict().items()}
    taken = overlay_(qa.backbone, pre.state_dict())
    assert sorted(taken) == sorted(qa.backbone.state_dict())
    for name, value in qa.backbone.state_dict().items():
        assert torch.equal(value, pre.state_dict()[name])
    assert all(torch.equal(v, head[k]) for k, v in qa.qa_head.state_dict().items())
    assert "mlm_score.decoder.weight" in pre.state_dict()
    assert not any(k.startswith(("mlm_score", "itm_score", "vid_proj"))
                   for k in qa.backbone.state_dict())


# ---------------- the data copies ----------------


def _videos(tmp_path, n=3):
    paths = []
    for i in range(n):
        path = tmp_path / "videos" / f"iv{i}.mp4"
        _write_mp4(path, seconds=1, res=40 + 8 * i, seed=50 + i)
        paths.append(str(path))
    return paths


def test_sampling_and_readers_match_jax(tmp_path):
    for fn, args in (("sample_frames", (4, 30)), ("sample_frames", (8, 5)),
                     ("sample_frames_start_end", (4, 3, 40))):
        for kw in ({"sample": "rand"}, {"sample": "uniform"},
                   {"sample": "rand", "fix_start": 2},
                   {"sample": "uniform", "fix_start": 1}):
            got = getattr(tsampling, fn)(*args, rng=np.random.default_rng(3), **kw)
            ref = getattr(jsampling, fn)(*args, rng=np.random.default_rng(3), **kw)
            assert got == ref
    assert tsampling.sliding_window_fix_starts(90, 4, 3) == \
        jsampling.sliding_window_fix_starts(90, 4, 3)
    assert tsampling.sample_frames_clips(3, 50, 40, 5) == \
        jsampling.sample_frames_clips(3, 50, 40, 5)
    for path in _videos(tmp_path):
        assert treaders.get_video_len(path) == jreaders.get_video_len(path) == 30
        for sample in ("rand", "uniform"):
            got, gi = treaders.read_frames_cv2(path, 4, sample,
                                               rng=np.random.default_rng(1))
            ref, ri = jreaders.read_frames_cv2(path, 4, sample,
                                               rng=np.random.default_rng(1))
            assert gi == ri and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    assert treaders.get_video_len(str(tmp_path / "missing.mp4")) == 0


def test_transforms_match_jax(monkeypatch):
    """Array for array, both packages on their numpy normalisation (their
    optional C++ kernel multiplies by 1/std: last-bit differences from
    numpy's; `tests/test_torch_data.py` holds the two on that kernel)."""
    from egovlpv2_torch.data import native as tnative
    from egovlpv2_tpu.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    clip = np.random.RandomState(0).rand(3, 48, 64, 3).astype(np.float32)
    for seed in range(3):
        got = ttransforms.train_transform(clip, np.random.default_rng(seed), size=32)
        ref = jtransforms.train_transform(clip, np.random.default_rng(seed), size=32)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ttransforms.eval_transform(clip, size=32),
                                  jtransforms.eval_transform(clip, size=32))
    np.testing.assert_array_equal(
        ttransforms.eval_transform(clip[:, :, :40], size=24, normalize=False),
        jtransforms.eval_transform(clip[:, :, :40], size=24, normalize=False))


def test_collate_and_loader_match_jax():
    items = [{"video": np.full((2, 3), i, np.float32), "answer": np.int32(i % 3),
              "score": float(i), "types": ["a"] * i} for i in range(11)]
    got = tloader.default_collate(items[:4])
    ref = jloader.default_collate(items[:4])
    assert got.keys() == ref.keys() and got["types"] == ref["types"]
    for k in ("video", "answer", "score"):
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype
    for kw in ({}, {"drop_last": False}, {"num_workers": 3, "prefetch": 1}):
        for shuffle in (False, True):
            for host in range(2):
                tl = tloader.DataLoader(items, 3, sampler=tloader.HostShardSampler(
                    len(items), 2, host, shuffle=shuffle, seed=4), **kw)
                jl = jloader.DataLoader(items, 3, sampler=jloader.HostShardSampler(
                    len(items), 2, host, shuffle=shuffle, seed=4), **kw)
                assert len(tl) == len(jl)
                for epoch in (0, 1):
                    tb, jb = list(tl.epoch(epoch)), list(jl.epoch(epoch))
                    assert len(tb) == len(jb) > 0
                    for a, b in zip(tb, jb):
                        np.testing.assert_array_equal(a["video"], b["video"])
                        assert a["types"] == b["types"]


def test_egotaskqa_dataset_matches_jax(tmp_path, monkeypatch):
    from egovlpv2_torch.data import native as tnative
    from egovlpv2_tpu.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    _videos(tmp_path)
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps([
        {"interval": f"iv{i % 3}", "question": f"what is in clip {i}",
         "answer_encode": i % 2, "type": "causal$descriptive" if i % 2 else ""}
        for i in range(4)]))
    for split in ("train", "val"):
        t = tdatasets.EgoTaskQADataset(str(qa), str(tmp_path / "videos"),
                                       num_frames=4, input_res=32, split=split,
                                       seed=2)
        j = jdatasets.EgoTaskQADataset(str(qa), str(tmp_path / "videos"),
                                       num_frames=4, input_res=32, split=split,
                                       seed=2)
        assert len(t) == len(j) == 4
        for i in range(5):  # past the end wraps, as in the JAX package
            got, ref = t[i], j[i]
            assert got.keys() == ref.keys()
            np.testing.assert_array_equal(got["video"], ref["video"])
            assert (got["text"], got["answer"], got["reasoning_types"]) == \
                (ref["text"], ref["answer"], ref["reasoning_types"])
            assert got["video"].shape == (4, 32, 32, 3)


# ---------------- cli taskqa ----------------


@pytest.fixture()
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture()
def taskqa_setup(tmp_path):
    vid_dir = tmp_path / "qa_videos"
    items = []
    for i in range(8):
        _write_mp4(vid_dir / f"iv{i}.mp4", seconds=1, seed=40 + i)
        items.append({
            "interval": f"iv{i}",
            "question": f"what happens in clip {i}",
            "answer_encode": i % 3,
            "type": "causal$descriptive" if i % 2 else "causal",
        })
    qa_train = tmp_path / "formatted_train_qas_encode.json"
    qa_val = tmp_path / "formatted_val_qas_encode.json"
    qa_train.write_text(json.dumps(items[:6]))
    qa_val.write_text(json.dumps(items[6:] + items[:2]))  # >= batch_size
    answers = tmp_path / "answer_set.txt"
    answers.write_text("yes\nno\nmaybe\n")
    rtypes = tmp_path / "all_reasoning_types.txt"
    rtypes.write_text("causal\ndescriptive\n")
    return {"videos": vid_dir, "qa_train": qa_train, "qa_val": qa_val,
            "answers": answers, "rtypes": rtypes}


def test_cli_taskqa_train_resume_testonly(tiny_config, tmp_path, taskqa_setup,
                                          monkeypatch, capsys):
    """The JAX CLI's test, on the port (`--device cpu`): train one epoch
    with checkpoints, resume to two epochs, then evaluate the saved
    checkpoint without training: the same accuracy as the resumed run."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    s = taskqa_setup
    save = tmp_path / "qa_ckpt"
    common = [
        "taskqa", "--config", tiny_config, "--device", "cpu",
        "--qa_train", str(s["qa_train"]), "--qa_val", str(s["qa_val"]),
        "--videos", str(s["videos"]), "--answer_set", str(s["answers"]),
        "--reasoning_types", str(s["rtypes"]),
        "--batch_size", "2", "--save_dir", str(save),
    ]
    out1 = tmp_path / "m1.json"
    res = cli.main(common + ["--epochs", "1", "--metrics_out", str(out1)])
    m1 = json.loads(out1.read_text())
    assert "acc" in m1 and "acc/causal" in m1
    assert [r["step"] for r in res["logged"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss_total"]) for r in res["logged"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == m1

    # resume: epoch 1 is already checkpointed, extend training to 2 epochs
    # (main_end2end.py:164-172 global_step -> start_epoch)
    out2 = tmp_path / "m2.json"
    res = cli.main(common + ["--epochs", "2", "--resume",
                             "--metrics_out", str(out2)])
    assert [r["step"] for r in res["logged"]] == [4, 5, 6]
    assert "acc" in json.loads(out2.read_text())

    # test-only: evaluate the saved checkpoint without training
    # (main_end2end.py:174-200)
    out3 = tmp_path / "m3.json"
    res = cli.main(common + ["--epochs", "2", "--test_only",
                             "--metrics_out", str(out3)])
    assert res["logged"] == []
    m3 = json.loads(out3.read_text())
    # same checkpoint, same eval data -> identical accuracy as the resume run
    assert m3["acc"] == json.loads(out2.read_text())["acc"]


def test_cli_taskqa_testonly_without_ckpt_raises(tiny_config, tmp_path,
                                                 taskqa_setup, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    s = taskqa_setup
    common = ["taskqa", "--config", tiny_config, "--device", "cpu",
              "--qa_train", str(s["qa_train"]), "--qa_val", str(s["qa_val"]),
              "--videos", str(s["videos"]), "--answer_set", str(s["answers"]),
              "--batch_size", "2"]
    with pytest.raises(FileNotFoundError):
        cli.main(common + ["--save_dir", str(tmp_path / "empty"), "--test_only"])
    with pytest.raises(ValueError, match="save_dir"):
        cli.main(common + ["--test_only"])
    with pytest.raises(NotImplementedError, match="A8"):
        cli.main(common + ["--ckpt", str(tmp_path)])
