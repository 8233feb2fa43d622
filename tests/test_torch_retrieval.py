"""The dual-encoder fine-tune slice of egovlpv2_torch against egovlpv2_tpu on
the CPU, f32: from the same parameters and batch, `dual_loss_fn` gives the
same loss and the same gradient for every parameter, three steps of
`make_dual_train_step` give the same parameters, and the evaluation
helpers give the same metrics from the same embeddings. Then the port's
own machinery: per-block rematerialisation, the milestone schedule and the
`ft-charades` / `ft-epic` commands."""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_tpu.tasks import retrieval as jret
from egovlpv2_tpu.train import optimizer as jopt
from egovlpv2_tpu.train import step as jstep
from egovlpv2_torch import cli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.tasks import retrieval as tret
from egovlpv2_torch.train import optimizer as topt
from egovlpv2_torch.train import step as tstep
from egovlpv2_torch.weights import state_dict_from_flax, training_init_
from torch_parity import perturb

torch.set_num_threads(2)
BATCH = 5
TEXT_LEN = 12
LOSSES = ["NormSoftmax", "AdaptiveMaxMargin"]


def _configs(loss_type="NormSoftmax", dropout=0.0, remat=False, **changes):
    """The tiny dual config of both packages: the pretrain tiny model with
    the small projection and no ITM/MLM head, as the fine-tune commands
    make it; the XLA attention path on the JAX side."""
    out = []
    for mod, pre in ((jconfig, jpretrain), (tconfig, tpretrain)):
        cfg = pre.tiny_train_config()
        text = mod.replace(cfg.model.text, hidden_dropout=dropout,
                           attn_dropout=dropout)
        video = mod.replace(cfg.model.video, drop_rate=dropout,
                            drop_path_rate=dropout)
        model = mod.replace(cfg.model, text=text, video=video, remat=remat,
                            attn_impl="xla", projection="small",
                            projection_dim=24, with_itm_head=False,
                            with_mlm_head=False)
        out.append(mod.replace(
            cfg, model=model, loss=mod.replace(cfg.loss, type=loss_type),
            tasks="Dual", max_text_len=TEXT_LEN, path_remat=False, **changes))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _batch(cfg, seed, relevancy):
    """A dual batch with texts that differ: padded ids of random lengths."""
    rs = np.random.RandomState(seed)
    v = cfg.model.video
    ids = rs.randint(4, cfg.model.text.vocab_size - 2, (BATCH, TEXT_LEN))
    ids[:, 0] = 0
    mask = np.ones((BATCH, TEXT_LEN), np.int32)
    for i, n in enumerate(rs.randint(4, TEXT_LEN + 1, BATCH)):
        ids[i, n - 1], ids[i, n:], mask[i, n:] = 2, 1, 0
    batch = {"video": rs.randn(BATCH, v.num_frames, v.img_size, v.img_size,
                               v.in_chans).astype(np.float32),
             "text_ids": ids.astype(np.int32), "text_mask": mask}
    if relevancy:
        batch["relevancy"] = rs.rand(BATCH).astype(np.float32)
    return batch


def _flax_params(jcfg, batch, seed=0):
    jmodel = JaxEgoVLPv2(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["video"][:1]),
                         jnp.asarray(batch["text_ids"][:1]),
                         jnp.asarray(batch["text_mask"][:1]),
                         method=jmodel.init_all)["params"]
    return jmodel, perturb(params, seed=seed)


def _torch_model(tcfg, params):
    """Strict: the bridge maps the dual model's tree (small projections, no
    heads, the fusion parameters the towers keep) name for name."""
    model = EgoVLPv2(tcfg.model)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.train()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("loss_type", LOSSES)
def test_dual_loss_and_every_gradient_match_jax(loss_type):
    """Tolerance 1e-4 for the loss, and for a gradient 1e-4 of max
    |reference| of its tensor (f32 sums in another order through 4 blocks
    of each tower); a tensor whose largest gradient is below 1e-2 is held
    to 1e-6 absolute (a key bias's gradient is zero but for rounding, about
    1e-7 on either side under a loss whose logits are divided by 0.05). A
    parameter the dual loss does not reach (the fusion parameters) has a
    zero gradient in JAX and none in PyTorch."""
    jcfg, tcfg = _configs(loss_type)
    batch = _batch(tcfg, 1, relevancy=loss_type == "AdaptiveMaxMargin")
    jmodel, params = _flax_params(jcfg, batch)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: jret.dual_loss_fn(p, _jbatch(batch), jax.random.PRNGKey(2),
                                    model=jmodel, cfg=jcfg), has_aux=True)(params)

    model = _torch_model(tcfg, params)
    loss, metrics = tret.dual_loss_fn(
        model, tstep.batch_to_device(batch, torch.device("cpu")), cfg=tcfg)
    loss.backward()
    assert set(metrics) == set(ref_metrics) == {"loss_total"}
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4, atol=1e-4)
    assert metrics["loss_total"].item() == loss.item() > 0.01
    ref = state_dict_from_flax(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    reached = 0
    for name, p in named.items():
        r = ref[name]
        if p.grad is None:
            assert not r.any(), name
            continue
        reached += 1
        scale = max(1e-2, r.abs().max().item())
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    assert reached > len(named) // 2


@pytest.mark.parametrize("loss_type", LOSSES)
def test_three_dual_steps_match_jax(loss_type):
    """make_dual_train_step of both packages, three steps on three batches
    (the first runs at lr 0 in both), with the clip on. Tolerances as
    `test_torch_pretrain.py`: 2e-4 absolute (times max |param| where that
    is above 1), eps = 1e-6 so that a gradient that is zero but for
    rounding stays still. The parameters the loss does not reach decay by
    the weight decay alone, in both."""
    optim = dict(lr=1e-3, max_steps=6, warmup_frac=0.34, grad_clip=1.0, eps=1e-6)
    jcfg, tcfg = _configs(loss_type)
    jcfg = jconfig.replace(jcfg, optim=jconfig.replace(jcfg.optim, **optim))
    tcfg = tconfig.replace(tcfg, optim=tconfig.replace(tcfg.optim, **optim))
    batches = [_batch(tcfg, 10 + i, relevancy=loss_type == "AdaptiveMaxMargin")
               for i in range(3)]
    jmodel, params = _flax_params(jcfg, batches[0], seed=3)
    tx = jopt.make_optimizer(jcfg.optim, params)
    jtrain = jret.make_dual_train_step(jmodel, jcfg, tx)
    state = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                             tx.init(params), jnp.zeros((), jnp.int32),
                             jax.random.PRNGKey(4))
    model = _torch_model(tcfg, params)
    optimizer, scheduler = topt.make_optimizer(tcfg.optim, model)
    # the towers keep their fusion parameters: all six groups have members
    assert [g["name"] for g in optimizer.param_groups] == list(topt.GROUPS)
    train = tret.make_dual_train_step(model, tcfg, optimizer, scheduler,
                                      torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, batch in enumerate(batches):
        state, ref_metrics = jtrain(state, _jbatch(batch))
        metrics = train(batch)
        assert set(metrics) == set(ref_metrics) == {"loss_total"}
        np.testing.assert_allclose(metrics["loss_total"].item(),
                                   float(ref_metrics["loss_total"]),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {i}")
    ref = state_dict_from_flax(state.params)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        scale = max(1.0, ref[name].abs().max().item())
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=2e-4, atol=2e-4 * scale, err_msg=name)
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 5e-4
    assert int(state.step) == 3 and scheduler.last_epoch == 3


def _dual_grads(cfg, batch, seed):
    model = training_init_(EgoVLPv2(cfg.model), torch.Generator().manual_seed(5))
    model.train()
    model.set_generator(torch.Generator().manual_seed(seed))
    loss, _ = tret.dual_loss_fn(
        model, tstep.batch_to_device(batch, torch.device("cpu")), cfg=cfg)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_block_remat_gives_the_same_dual_gradients(dropout):
    """`model.remat`: one checkpoint region a video block and a text layer,
    rebuilt in the backward with the dropout masks of the first run. Loss
    and gradients as without it, to 1e-6 (f32 rounding: the rebuilt
    forward repeats the same operations)."""
    plain_cfg = _configs(dropout=dropout)[1]
    remat_cfg = _configs(dropout=dropout, remat=True)[1]
    batch = _batch(plain_cfg, 2, relevancy=False)
    plain_loss, plain = _dual_grads(plain_cfg, batch, seed=0)
    remat_loss, remat = _dual_grads(remat_cfg, batch, seed=0)
    torch.testing.assert_close(remat_loss, plain_loss, rtol=1e-6, atol=1e-6)
    for name, g in plain.items():
        if g is None:
            assert remat[name] is None, name
            continue
        torch.testing.assert_close(remat[name], g, rtol=1e-5, atol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    if dropout:
        other_loss, _ = _dual_grads(plain_cfg, batch, seed=1)
        assert other_loss.item() != plain_loss.item()


def test_block_remat_wraps_blocks_only_in_training(monkeypatch):
    calls = []
    from egovlpv2_torch.models import text as ttext, video as tvideo
    real = tvideo.checkpoint_region
    spy = lambda fn, gen: (calls.append(gen), real(fn, gen))[1]
    monkeypatch.setattr(tvideo, "checkpoint_region", spy)
    monkeypatch.setattr(ttext, "checkpoint_region", spy)
    cfg = _configs(remat=True)[1]
    batch = tstep.batch_to_device(_batch(cfg, 3, False), torch.device("cpu"))
    model = training_init_(EgoVLPv2(cfg.model), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    model.set_generator(gen)
    model.eval()
    tret.dual_loss_fn(model, batch, cfg=cfg)
    with torch.no_grad():
        tret.dual_loss_fn(model.train(), batch, cfg=cfg)
    assert calls == []
    tret.dual_loss_fn(model.train(), batch, cfg=cfg)
    assert len(calls) == cfg.model.video.depth + cfg.model.text.num_layers
    assert all(g is gen for g in calls)


# ---------------- evaluation helpers ----------------


def test_encoders_match_jax_and_restore_the_mode():
    jcfg, tcfg = _configs(dropout=0.1)
    batch = _batch(tcfg, 4, relevancy=False)
    jmodel, params = _flax_params(jcfg, batch, seed=6)
    jtext, jvideo = jret.make_encoders(jmodel)
    model = _torch_model(tcfg, params)
    ttext, tvideo = tret.make_encoders(model)
    assert model.training
    t, v = ttext(batch["text_ids"], batch["text_mask"]), tvideo(batch["video"])
    assert model.training  # dropout was off inside, and is on again
    assert t.dtype == v.dtype == np.float32 and t.shape == v.shape == (BATCH, 24)
    np.testing.assert_allclose(
        t, np.asarray(jtext(params, batch["text_ids"], batch["text_mask"])),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v, np.asarray(jvideo(params, batch["video"])),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t, ttext(batch["text_ids"], batch["text_mask"]))


def test_pool_windows_and_align_match():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((9, 6)).astype(np.float32)
    idx = np.array([3, 1, 3, 0, 1, 3, 2, 0, 4])
    texts = rng.standard_normal((9, 6)).astype(np.float32)
    targets = rng.integers(0, 2, (9, 5))
    ref = jret.pool_windows(v, idx, texts, targets)
    got = tret.pool_windows(v, idx, texts, targets)
    assert len(ref) == len(got) == 4
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0][3], v[[0, 2, 5]].mean(0), rtol=1e-6)
    np.testing.assert_array_equal(got[2][3], texts[0])  # the first row wins

    sim = rng.standard_normal((6, 6))
    order = rng.permutation(6)
    video_ids = np.array([f"v{i}" for i in range(6)])
    sentence_ids = np.array(["v4", "v0", "v3"])
    np.testing.assert_array_equal(
        tret.align_mir_similarity(sim, order, video_ids, sentence_ids),
        jret.align_mir_similarity(sim, order, video_ids, sentence_ids))


def _seeded_encoders(monkeypatch, dim=16):
    """Both packages' `make_encoders` replaced by the same seeded maps from
    a batch's arrays to embeddings, so the evaluation loops are compared on
    identical embeddings."""
    rs = np.random.RandomState(7)
    table = rs.randn(64, dim).astype(np.float32)
    proj = rs.randn(12, dim).astype(np.float32)
    text = lambda ids, mask: table[np.asarray(ids)[:, 1]] * np.asarray(
        mask).sum(1, keepdims=True).astype(np.float32)
    video = lambda vid: np.asarray(vid).reshape(len(vid), -1)[:, :12] @ proj
    monkeypatch.setattr(jret, "make_encoders", lambda model: (
        lambda params, ids, mask: text(ids, mask), lambda params, v: video(v)))
    monkeypatch.setattr(tret, "make_encoders", lambda model: (text, video))


def _eval_batches(n_videos, windows, seed, n_classes=None):
    """`windows` entries a video sharing its idx, shuffled, in batches of 4."""
    rs = np.random.RandomState(seed)
    idx = rs.permutation(np.repeat(np.arange(n_videos), windows))
    ids = np.zeros((len(idx), 4), np.int32)
    ids[:, 1] = 5 + idx  # one caption a video
    mask = np.ones((len(idx), 4), np.int32)
    mask[idx % 2 == 0, 3] = 0
    video = rs.randn(len(idx), 2, 2, 2, 3).astype(np.float32)
    target = None
    if n_classes:
        target = (rs.rand(n_videos, n_classes) < 0.3).astype(np.int64)[idx]
    for s in range(0, len(idx), 4):
        b = {"video": video[s:s + 4], "text_ids": ids[s:s + 4],
             "text_mask": mask[s:s + 4], "idx": idx[s:s + 4]}
        if target is not None:
            b["target"] = target[s:s + 4]
        yield b


@pytest.mark.parametrize("windows", [1, 3], ids=["plain", "sliding_windows"])
@pytest.mark.parametrize("official_ids", [False, True])
def test_evaluate_mir_matches(monkeypatch, windows, official_ids):
    _seeded_encoders(monkeypatch)
    n = 10
    rs = np.random.RandomState(8)
    kw = {}
    if official_ids:
        kw = dict(video_ids=np.array([f"P{i:02d}" for i in range(n)]),
                  sentence_video_ids=np.array(
                      [f"P{i:02d}" for i in rs.permutation(n)[:7]]))
    cols = 7 if official_ids else n
    relevancy = np.round(rs.rand(n, cols), 2)
    relevancy[np.arange(n), rs.randint(0, cols, n)] = 1.0
    relevancy[rs.randint(0, n, cols), np.arange(cols)] = 1.0
    seen = {}
    ref = jret.evaluate_mir(None, None, _eval_batches(n, windows, 9), relevancy,
                            on_sim=lambda s, i: seen.update(ref=(s, i)), **kw)
    got = tret.evaluate_mir(None, _eval_batches(n, windows, 9), relevancy,
                            on_sim=lambda s, i: seen.update(got=(s, i)), **kw)
    assert list(got) == list(ref) and len(got) == 6
    for key in ref:  # rank metrics of the same similarities: equal
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, err_msg=key)
    np.testing.assert_allclose(seen["got"][0], seen["ref"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(seen["got"][1], seen["ref"][1])
    assert seen["got"][0].shape == (n, n)


@pytest.mark.parametrize("windows", [1, 2], ids=["plain", "sliding_windows"])
def test_evaluate_charades_matches(monkeypatch, windows):
    _seeded_encoders(monkeypatch)
    n_classes = 6
    prompts = np.zeros((n_classes, 4), np.int32)
    prompts[:, 1] = 40 + np.arange(n_classes)
    prompt_mask = np.ones((n_classes, 4), np.int32)
    ref = jret.evaluate_charades(None, None, _eval_batches(14, windows, 10, n_classes),
                                 prompts, prompt_mask)
    got = tret.evaluate_charades(None, _eval_batches(14, windows, 10, n_classes),
                                 prompts, prompt_mask)
    assert list(got) == list(ref) == ["mAP"]
    np.testing.assert_allclose(got["mAP"], ref["mAP"], rtol=1e-9)
    assert 0.0 < got["mAP"] < 1.0


def test_milestone_schedules_match():
    for epoch in range(6):
        assert tret.milestone_lr_scale(epoch, (2, 4)) \
            == jret.milestone_lr_scale(epoch, (2, 4))
    ref = jret.epoch_milestone_schedule(3e-5, (2, 4), 5)
    got = tret.epoch_milestone_schedule(3e-5, (2, 4), 5)
    assert isinstance(ref(0), jax.Array) and optax is not None
    for count in range(26):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6)
    # as the multiplier of the port's LambdaLR
    cfg = tconfig.OptimConfig(lr=1e-3, max_steps=40, warmup_frac=0.1)
    model = torch.nn.ModuleDict({"fc": torch.nn.Linear(2, 2)})
    plain = topt.make_schedule(cfg)
    optimizer, scheduler = topt.make_optimizer(
        cfg, model, lr_scale=tret.epoch_milestone_schedule(1.0, (2, 4), 5))
    for count in range(26):
        np.testing.assert_allclose(
            scheduler.get_last_lr()[0],
            1e-3 * plain(count) * 0.1 ** sum(count >= b for b in (10, 20)),
            rtol=1e-6, atol=1e-12)
        optimizer.step()
        scheduler.step()


def test_train_retrieval_epochs_runs_and_validates():
    cfg = _configs()[1]
    cfg = tconfig.replace(cfg, optim=tconfig.replace(cfg.optim, lr=1e-3,
                                                     max_steps=8))
    model, _, scheduler, step = tret.build_dual(cfg, device="cpu")
    logs, evals = [], []
    history = tret.train_retrieval_epochs(
        model, step,
        lambda epoch: (_batch(cfg, 20 + epoch * 2 + i, False) for i in range(2)),
        eval_fn=lambda m: evals.append(m.training) or {"epochs": len(evals)},
        epochs=2, log_fn=lambda s, m: logs.append((s, m)))
    assert history == [{"epochs": 1}, {"epochs": 2}]
    assert [s for s, _ in logs] == [1, 2, 3, 4] and scheduler.last_epoch == 4
    assert all(np.isfinite(m["loss_total"]) for _, m in logs)


# ---------------- the commands ----------------

TINY_SETS = ["model.video.img_size=32", "model.video.embed_dim=32",
             "model.video.depth=2", "model.video.num_heads=2",
             "model.video.num_frames=2", "model.text.vocab_size=256",
             "model.text.hidden_size=32", "model.text.num_layers=2",
             "model.text.num_heads=2", "model.text.intermediate_size=64",
             "model.text.max_position_embeddings=40",
             "model.fusion.num_fuse_block=1", "model.fusion.dim_video=32",
             "model.fusion.dim_text=32", "model.fusion.hidden_size=32",
             "global_batch_size=4", "optim.max_steps=10", "optim.lr=1e-3"]


@pytest.mark.parametrize("command, loss_type, remat", [
    ("ft-charades", "NormSoftmax", "true"), ("ft-epic", "AdaptiveMaxMargin", "false")])
def test_cli_dual_finetune_runs_on_cpu(capsys, monkeypatch, command, loss_type,
                                       remat):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    res = cli.main([command, "--synthetic", "--device", "cpu", "--epochs", "2",
                    "--steps_per_epoch", "2", "--log_every", "2", "--set",
                    *TINY_SETS, f"model.remat={remat}"])
    cfg = res["config"]
    assert (cfg.loss.type, cfg.max_text_len) == (loss_type, 30)
    assert (cfg.model.projection, cfg.model.projection_dim) == ("small", 256)
    assert not (cfg.model.with_itm_head or cfg.model.with_mlm_head)
    assert len(res["step_seconds"]) == 4 and res["clips_per_step"] == 4
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == len(res["logged"]) == 2
    for line, row in zip(lines, res["logged"]):
        assert json.loads(line) == row
        assert set(row) == {"epoch", "step", "step_ms", "loss_total"}
        assert all(np.isfinite(v) for v in row.values())
    assert [r["step"] for r in res["logged"]] == [2, 4]
    fresh = training_init_(EgoVLPv2(cfg.model), torch.Generator().manual_seed(0))
    named = dict(res["model"].named_parameters())
    assert not any(n.startswith(("itm_score", "mlm_score", "cross_modal"))
                   for n in named)
    changed = [not torch.equal(named[n], q) for n, q in fresh.named_parameters()]
    assert sum(changed) > 0.5 * len(changed)


def test_synthetic_dual_batch_matches_the_jax_cli_draws(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    from egovlpv2_torch.data.tokenizer import Tokenizer
    cfg = tconfig.load_train_config(None, TINY_SETS + ["max_text_len=30"])
    tok = Tokenizer("roberta-base", max_len=30, vocab_cap=256)
    rng = np.random.default_rng(0)
    first = tret.synthetic_dual_batch(cfg, 4, rng, tok, relevancy=True)
    second = tret.synthetic_dual_batch(cfg, 4, rng, tok)
    ref = np.random.default_rng(0)  # the draws of egovlpv2_tpu/cli.py:563-584
    for b in (first, second):
        np.testing.assert_array_equal(
            b["video"], ref.standard_normal((4, 2, 32, 32, 3)).astype(np.float32))
        assert b["text_ids"].shape == b["text_mask"].shape == (4, 30)
    np.testing.assert_array_equal(first["relevancy"], np.ones(4, np.float32))
    assert set(second) == {"video", "text_ids", "text_mask"}


def test_cli_dual_finetune_refuses_what_is_not_ported(tmp_path):
    """The fine-tunes refuse none of their flags any more: a --ckpt
    directory without a checkpoint raises FileNotFoundError, --save_dir
    writes the run's files, --resume goes on from them, --init_val without
    --val_meta has nothing to validate, and --visualize writes pages only
    for an EK-100 validation with a save directory. They refuse a run with
    neither files nor --synthetic, and a card that is not there."""
    for command in ("ft-charades", "ft-epic"):
        base = [command, "--device", "cpu"]
        tiny = ["--synthetic", "--steps_per_epoch", "1", "--set",
                *TINY_SETS]
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            cli.main(base + tiny + ["--ckpt", str(tmp_path)])
        save = tmp_path / command
        res = cli.main(base + tiny + ["--save_dir", str(save), "--init_val",
                                      "--visualize"])
        assert [r["step"] for r in res["logged"]] == [1] and res["val"] == []
        assert {"config.json", "info.log", "stats.txt", "ckpt"} <= set(
            os.listdir(save))
        assert not (save / "web").exists()
        res = cli.main(base + tiny + ["--save_dir", str(save), "--resume",
                                      "--epochs", "2"])
        assert [r["step"] for r in res["logged"]] == [2]
        # files or synthetic batches, never a silent fallback
        with pytest.raises(ValueError, match="--meta"):
            cli.main(base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["ft-charades", "--synthetic", "--device", "cuda"])
