"""The pretrain slice of egovlpv2_torch as a whole against egovlpv2_tpu on
the CPU, f32: from the same parameters, the same synthetic batch and the
same mined ITM indices, `pretrain_loss_fn` gives the same loss parts and
the same gradient for every parameter, and three optimizer steps give the
same parameters. Then the port's own machinery: path and per-block
rematerialisation, dropout under them, the refusals, and the `pretrain`
command."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.objectives.itm_mining import ITMIndices as JITMIndices
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_tpu.train import optimizer as jopt
from egovlpv2_tpu.train import step as jstep
from egovlpv2_torch import cli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.objectives.itm_mining import ITMIndices
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.train import optimizer as topt
from egovlpv2_torch.train import step as tstep
from egovlpv2_torch.weights import state_dict_from_flax
from torch_parity import perturb

torch.set_num_threads(2)
BATCH = 6
PARTS = ("loss_egonce", "loss_mlm", "loss_itm", "loss_total")
# mined pairs used on both sides: 3 positives, 2 swapped videos, 1 swapped text
VIDEO_IDX = np.array([0, 3, 2, 5, 4, 1])
TEXT_IDX = np.array([0, 1, 2, 3, 0, 5])
LABELS = np.array([1, 0, 1, 0, 0, 0])


def _configs(**changes):
    """The tiny pretrain config of both packages: dropout 0 (deterministic),
    no remat, the XLA attention path on the JAX side."""
    out = []
    for mod, pre in ((jconfig, jpretrain), (tconfig, tpretrain)):
        cfg = pre.tiny_train_config()
        text = mod.replace(cfg.model.text, hidden_dropout=0.0, attn_dropout=0.0)
        model = mod.replace(cfg.model, text=text, remat=False, attn_impl="xla")
        out.append(mod.replace(cfg, model=model, path_remat=False, **changes))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _flax_params(jcfg, batch, seed=0):
    jmodel = JaxEgoVLPv2(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["video"][:1]),
                         jnp.asarray(batch["text_ids"][:1]),
                         jnp.asarray(batch["text_mask"][:1]),
                         method=jmodel.init_all)["params"]
    return jmodel, perturb(params, seed=seed)


def _inject_indices(monkeypatch):
    monkeypatch.setattr(jstep, "mine_itm_indices", lambda *a, **k: JITMIndices(
        jnp.asarray(VIDEO_IDX), jnp.asarray(TEXT_IDX), jnp.asarray(LABELS)))
    monkeypatch.setattr(tstep, "mine_itm_indices", lambda *a, **k: ITMIndices(
        torch.from_numpy(VIDEO_IDX), torch.from_numpy(TEXT_IDX),
        torch.from_numpy(LABELS)))


def _torch_model(tcfg, params):
    model = EgoVLPv2(tcfg.model)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.train()


def _assert_trees_match(model, flax_tree, what, tol, floor):
    """Every torch parameter (or its .grad) against its flax leaf, within
    `tol` of max(`floor`, max |reference|) of that tensor; nothing left
    unmapped on either side."""
    ref = state_dict_from_flax(flax_tree)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        got = p.grad if what == "grad" else p.detach()
        assert got is not None, name
        scale = max(floor, ref[name].abs().max().item())
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("loss_type, loss_scale", [("EgoNCE", 1.0),
                                                   ("NormSoftmax", 0.5)])
def test_loss_parts_and_every_gradient_match_jax(monkeypatch, loss_type,
                                                 loss_scale):
    """Tolerance 1e-4, for a gradient 1e-4 of max |reference| of its
    tensor: f32 sums in another order through 8 blocks and three objective
    paths. A tensor whose largest gradient is below 1e-3 is held to 1e-7
    absolute: the key bias of a softmax attention has a gradient that is
    zero but for rounding, about 1e-8 on either side."""
    jcfg, tcfg = _configs()
    jcfg = jconfig.replace(jcfg, loss=jconfig.replace(jcfg.loss, type=loss_type))
    tcfg = tconfig.replace(tcfg, loss=tconfig.replace(tcfg.loss, type=loss_type))
    batch = tpretrain.synthetic_batch(tcfg, BATCH, np.random.default_rng(1))
    jmodel, params = _flax_params(jcfg, batch)
    _inject_indices(monkeypatch)

    def jloss(p):
        return jstep.pretrain_loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(2), model=jmodel, cfg=jcfg, loss_scale=loss_scale)

    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = _torch_model(tcfg, params)
    loss, metrics = tstep.pretrain_loss_fn(
        model, tstep.batch_to_device(batch, torch.device("cpu")),
        torch.Generator().manual_seed(0), cfg=tcfg, loss_scale=loss_scale)
    loss.backward()
    assert set(metrics) == set(ref_metrics) == set(PARTS)
    for key in PARTS:
        np.testing.assert_allclose(metrics[key].item(), float(ref_metrics[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), loss_scale * metrics["loss_total"].item(),
                               rtol=1e-6)
    _assert_trees_match(model, ref_grads, "grad", 1e-4, floor=1e-3)


@pytest.mark.parametrize("method", ["mlm_forward", "mlm_itm_forward_from_video"])
def test_mlm_entry_points_match_jax(method):
    """The two MLM entry points the step itself does not call, in training
    mode with dropout 0: `mlm_forward` from pixels, and the 2B-wide
    `mlm_itm_forward_from_video` on the unfused video tokens of the batch
    and of a permuted batch. Logits within 1e-4; the gradient of
    sum(logits * cotangent) for every parameter within 1e-4 of
    max(1, max |reference|) of its tensor (f32 sums in another order; under
    these O(1) cotangents a key bias's gradient, zero but for rounding, is
    about 1e-6 on either side). A
    parameter the method does not reach has a zero gradient in JAX and none
    in PyTorch."""
    jcfg, tcfg = _configs()
    batch = tpretrain.synthetic_batch(tcfg, BATCH, np.random.default_rng(7))
    jmodel, params = _flax_params(jcfg, batch, seed=8)
    video, mask = batch["video"], batch["text_mask"]
    mlm_ids, ids = batch["text_mlm_ids"], batch["text_ids"]
    rs = np.random.RandomState(9)
    vocab = tcfg.model.text.vocab_size
    cots = [rs.randn(BATCH, ids.shape[1], vocab).astype(np.float32)]
    if method == "mlm_itm_forward_from_video":
        cots.append(rs.randn(BATCH, 2).astype(np.float32))

    def jfn(p):
        def call(fn, *args):
            return jmodel.apply({"params": p}, *args, deterministic=False,
                                method=fn, rngs={"dropout": jax.random.PRNGKey(1)})
        if method == "mlm_forward":
            return (call(jmodel.mlm_forward, jnp.asarray(video),
                         jnp.asarray(mlm_ids), jnp.asarray(mask)),)
        v_un = call(jmodel.video_unfused, jnp.asarray(video))
        return call(jmodel.mlm_itm_forward_from_video, v_un, jnp.asarray(mlm_ids),
                    jnp.asarray(mask), v_un[VIDEO_IDX], jnp.asarray(ids[TEXT_IDX]),
                    jnp.asarray(mask[TEXT_IDX]))

    ref, vjp = jax.vjp(jfn, params)
    (ref_grads,) = vjp(tuple(jnp.asarray(c) for c in cots))

    model = _torch_model(tcfg, params)
    t = lambda a: torch.from_numpy(np.asarray(a))
    if method == "mlm_forward":
        got = (model.mlm_forward(t(video), t(mlm_ids).long(), t(mask)),)
    else:
        v_un = model.video_unfused(t(video))
        got = model.mlm_itm_forward_from_video(
            v_un, t(mlm_ids).long(), t(mask), v_un[t(VIDEO_IDX)],
            t(ids[TEXT_IDX]).long(), t(mask[TEXT_IDX]))
    assert len(got) == len(ref) == len(cots)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
    sum((g * t(c)).sum() for g, c in zip(got, cots)).backward()
    ref_grads = state_dict_from_flax(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    reached = 0
    for name, p in named.items():
        r = ref_grads[name]
        if p.grad is None:
            assert not r.any(), name
            continue
        reached += 1
        np.testing.assert_allclose(
            p.grad.numpy(), r.numpy(), rtol=1e-4, err_msg=name,
            atol=1e-4 * max(1.0, r.abs().max().item()))
    assert reached > len(named) // 2


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_three_optimizer_steps_match_jax(monkeypatch, grad_clip):
    """make_train_step of both packages, three steps on three batches (the
    first runs at lr 0 in both). lr is raised so that the steps move the
    parameters well above the tolerance, 2e-4 absolute (times max |param|
    where that is above 1).
    Adam's u = m/(sqrt(v) + eps) turns a gradient that is zero but for
    rounding (the key bias of a softmax attention) into a step of +-lr, in
    each package after its own rounding; eps = 1e-6 on both sides, far
    above that rounding and far below the real gradients, keeps such
    elements still."""
    optim = dict(lr=1e-3, max_steps=6, warmup_frac=0.34, grad_clip=grad_clip,
                 eps=1e-6)
    jcfg, tcfg = _configs(log_grad_norm=True)
    jcfg = jconfig.replace(jcfg, optim=jconfig.replace(jcfg.optim, **optim))
    tcfg = tconfig.replace(tcfg, optim=tconfig.replace(tcfg.optim, **optim))
    batches = [tpretrain.synthetic_batch(tcfg, BATCH, np.random.default_rng(10 + i))
               for i in range(3)]
    jmodel, params = _flax_params(jcfg, batches[0], seed=3)
    _inject_indices(monkeypatch)

    tx = jopt.make_optimizer(jcfg.optim, params)
    jtrain = jstep.make_train_step(jmodel, jcfg, tx)
    state = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                             tx.init(params), jnp.zeros((), jnp.int32),
                             jax.random.PRNGKey(4))
    model = _torch_model(tcfg, params)
    optimizer, scheduler = topt.make_optimizer(tcfg.optim, model)
    train = tstep.make_train_step(model, tcfg, optimizer, scheduler,
                                  torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, batch in enumerate(batches):
        state, ref_metrics = jtrain(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = train(batch)
        assert set(metrics) == set(ref_metrics) == set(PARTS) | {"grad_norm"}
        for key in metrics:
            np.testing.assert_allclose(metrics[key].item(), float(ref_metrics[key]),
                                       rtol=2e-4, atol=2e-4, err_msg=f"{key} step {i}")
        if i == 0:  # lr 0 at the first update: nothing moved, on either side
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), start[n]), n
    _assert_trees_match(model, state.params, "param", 2e-4, floor=1.0)
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 5e-4  # the steps did move the parameters
    assert int(state.step) == 3 and scheduler.last_epoch == 3


def _grads(cfg, batch, seed, path_remat):
    model = EgoVLPv2(cfg.model)
    tpretrain.training_init_(model, torch.Generator().manual_seed(5))
    with torch.no_grad():  # open the gates so that every path carries signal
        for name, p in model.named_parameters():
            if name.endswith(("alpha_i2t", "alpha_t2i")):
                p.fill_(0.5)
    model.train()
    gen = torch.Generator().manual_seed(seed)
    model.set_generator(gen)
    loss, metrics = tstep.pretrain_loss_fn(
        model, tstep.batch_to_device(batch, torch.device("cpu")), gen, cfg=cfg,
        path_remat=path_remat)
    loss.backward()
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_path_remat_gives_the_same_gradients(dropout):
    """One checkpoint region a path rebuilds the forward in the backward,
    with the dropout masks of the first run (the generator's state is put
    back for the rebuild): the same losses and gradients, to f32 rounding."""
    cfg = _configs()[1]
    text = tconfig.replace(cfg.model.text, hidden_dropout=dropout, attn_dropout=dropout)
    video = tconfig.replace(cfg.model.video, drop_rate=dropout, drop_path_rate=dropout)
    cfg = tconfig.replace(cfg, model=tconfig.replace(cfg.model, text=text, video=video))
    batch = tpretrain.synthetic_batch(cfg, BATCH, np.random.default_rng(2))
    plain_m, plain = _grads(cfg, batch, seed=0, path_remat=False)
    remat_m, remat = _grads(cfg, batch, seed=0, path_remat=True)
    for key in PARTS:
        torch.testing.assert_close(remat_m[key], plain_m[key], rtol=1e-6, atol=1e-6)
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=1e-5, atol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    if dropout:
        other_m, _ = _grads(cfg, batch, seed=1, path_remat=False)
        assert other_m["loss_total"].item() != plain_m["loss_total"].item()


def test_training_mode_dropout_is_on_and_eval_is_not():
    cfg = tpretrain.tiny_train_config()
    model = EgoVLPv2(cfg.model)
    tpretrain.training_init_(model, torch.Generator().manual_seed(0))
    batch = tpretrain.synthetic_batch(cfg, 4, np.random.default_rng(0))
    ids = torch.from_numpy(batch["text_ids"]).long()
    mask = torch.from_numpy(batch["text_mask"])
    model.set_generator(torch.Generator().manual_seed(0))
    model.train()
    a, b = model.compute_text(ids, mask), model.compute_text(ids, mask)
    assert not torch.equal(a, b)  # text dropout 0.1 draws anew
    model.eval()
    assert torch.equal(model.compute_text(ids, mask), model.compute_text(ids, mask))


def test_step_refuses_per_block_remat():
    """It refused once; now `tiny_train_config`, with `model.remat` on as
    the JAX package's, runs as given: every block is a checkpoint region
    and the paths are not (`path_remat and not model.remat`)."""
    cfg = tpretrain.tiny_train_config()
    assert cfg.model.remat and cfg.path_remat
    model, _, _, train = tpretrain.build_pretrain(cfg, device="cpu")
    assert model.video_model.remat and model.text_model.remat
    metrics = train(tpretrain.synthetic_batch(cfg, 4))
    assert set(metrics) == set(PARTS)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_block_remat_gives_the_same_gradients(dropout):
    """`model.remat`: one checkpoint region a video block and a text layer,
    in all three objective paths; the same losses and gradients as without
    it, to f32 rounding, with the dropout masks of the first run."""
    cfg = _configs()[1]
    text = tconfig.replace(cfg.model.text, hidden_dropout=dropout, attn_dropout=dropout)
    video = tconfig.replace(cfg.model.video, drop_rate=dropout, drop_path_rate=dropout)
    cfg = tconfig.replace(cfg, model=tconfig.replace(cfg.model, text=text, video=video))
    remat_cfg = tconfig.replace(cfg, model=tconfig.replace(cfg.model, remat=True))
    batch = tpretrain.synthetic_batch(cfg, BATCH, np.random.default_rng(2))
    plain_m, plain = _grads(cfg, batch, seed=0, path_remat=False)
    # path_remat is asked for and gives way to the blocks' own regions
    remat_m, remat = _grads(remat_cfg, batch, seed=0, path_remat=True)
    for key in PARTS:
        torch.testing.assert_close(remat_m[key], plain_m[key], rtol=1e-6, atol=1e-6)
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=1e-5, atol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_training_init_follows_the_jax_init():
    """Not its draws, its distributions: zeros, ones and the standard
    deviation of each kind of leaf agree with `init_all`'s."""
    jcfg, tcfg = _configs()
    batch = tpretrain.synthetic_batch(tcfg, 2)
    jmodel = JaxEgoVLPv2(jcfg.model)
    ref = state_dict_from_flax(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["video"][:1]),
        jnp.asarray(batch["text_ids"][:1]), jnp.asarray(batch["text_mask"][:1]),
        method=jmodel.init_all)["params"])
    a = tpretrain.training_init_(EgoVLPv2(tcfg.model), torch.Generator().manual_seed(0))
    b = tpretrain.training_init_(EgoVLPv2(tcfg.model), torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        r = ref[name]
        if r.numel() == 1 or r.std() == 0:  # gates, zeros, ones
            assert torch.equal(p.detach(), r), name
        elif r.numel() >= 1024:  # enough draws to compare a deviation
            assert abs(p.std().item() / r.std().item() - 1) < 0.15, name
            assert abs(p.mean().item()) < 0.2 * r.std().item() + 1e-3, name


def test_cli_pretrain_runs_on_cpu(capsys):
    cfg = tpretrain.tiny_train_config()
    sets = ["model.video.img_size=32", "model.video.embed_dim=32",
            "model.video.depth=4", "model.video.num_heads=2",
            "model.video.num_frames=2", "model.text.vocab_size=256",
            "model.text.hidden_size=32", "model.text.num_layers=4",
            "model.text.num_heads=2", "model.text.intermediate_size=64",
            "model.text.max_position_embeddings=40",
            "model.fusion.num_fuse_block=2", "model.fusion.dim_video=32",
            "model.fusion.dim_text=32", "model.fusion.hidden_size=32",
            "model.projection_dim=64", "model.remat=false",
            "global_batch_size=4", "optim.max_steps=10", "optim.lr=1e-3",
            "max_text_len=12", "log_grad_norm=true"]
    assert dataclasses.asdict(tconfig.load_train_config(None, sets).model.video) \
        == dataclasses.asdict(cfg.model.video)
    res = cli.main(["pretrain", "--synthetic", "--device", "cpu", "--epochs", "2",
                    "--steps_per_epoch", "2", "--log_every", "2", "--set", *sets])
    assert len(res["step_seconds"]) == 4 and res["clips_per_step"] == 4
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == len(res["logged"]) == 2
    import json
    for line, row in zip(lines, res["logged"]):
        assert json.loads(line) == row
        assert set(row) == {"epoch", "step", "step_ms", "grad_norm", *PARTS}
        assert all(np.isfinite(v) for v in row.values())
    assert [r["step"] for r in res["logged"]] == [2, 4]
    fresh = tpretrain.training_init_(EgoVLPv2(res["model"].cfg),
                                     torch.Generator().manual_seed(0))
    changed = [not torch.equal(p, q) for p, q in
               zip(res["model"].parameters(), fresh.parameters())]
    assert sum(changed) > 0.8 * len(changed)


def test_cli_pretrain_refuses_what_is_not_ported():
    base = ["pretrain", "--device", "cpu"]
    for extra, what in ((["--synthetic", "--save_dir", "out"], "checkpoints"),
                        (["--synthetic", "--resume"], "checkpoints"),
                        (["--synthetic", "--val_meta", "egomcq.json"],
                         "training loop")):
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            cli.main(base + extra)
        assert what in str(err.value)
    # files or synthetic batches, never a silent fallback
    with pytest.raises(ValueError, match="--meta"):
        cli.main(base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["pretrain", "--synthetic", "--device", "cuda"])
