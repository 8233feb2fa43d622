"""The QFVS slice of egovlpv2_torch against egovlpv2_tpu on the CPU, f32:
the copies free of JAX (`qfvs_data`: the dataset, prompts, shot packing,
Tags.mat; the semantic matching F1 and shot selection of `qfvs`); the
summary scorer's logits, loss and every gradient from the same parameters
(through the weight bridge, both ways) at d_model 32, 2 heads, 2 layers,
dropout 0; three steps of its AdamW at the cosine rate against optax; and
`run_qfvs` end to end on the same items from the same initial parameters,
dropout 0 on both sides (flax's `nn.Dropout` patched to rate 0).

Tolerances: logits, loss and gradients within 1e-4 of the largest
|reference| of each tensor (f32 sums in another order); parameters after
three steps within 2e-4 (of |param| where that is above 1); the selected
shots and the F1 equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from flax import linen as nn

from egovlpv2_tpu.downstream import qfvs as jqfvs
from egovlpv2_tpu.downstream import qfvs_data as jqfvs_data
from egovlpv2_tpu.downstream import runners as jrunners
from egovlpv2_tpu.tasks import orchestrators as jorch
from egovlpv2_tpu.train.step import TrainState
from egovlpv2_torch.downstream import qfvs as tqfvs
from egovlpv2_torch.downstream import qfvs_data as tqfvs_data
from egovlpv2_torch.downstream import runners as trunners
from egovlpv2_torch.models.dropout import Dropout
from egovlpv2_torch.tasks import orchestrators as torch_orch
from egovlpv2_torch.weights import flax_from_state_dict, state_dict_from_flax
from torch_parity import (assert_close_by_max, assert_grads_match,
                          assert_steps_match, perturb)

torch.set_num_threads(2)
D_MODEL = 32


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for module in model.modules():
        if isinstance(module, Dropout):
            module.rate = 0.0
    return model


@pytest.fixture()
def flax_without_dropout(monkeypatch):
    """flax's `nn.Dropout` at rate 0 for the test (the JAX scorer and its
    runner hard-code theirs)."""
    dropout = nn.Dropout
    monkeypatch.setattr(nn, "Dropout",
                        lambda rate, *a, **k: dropout(0.0, *a, **k))


# ---------------- the copies free of JAX ----------------


def _write_qfvs_files(tmp_path, videos=(1, 2), segs=8, shots=4, width=16):
    rs = np.random.RandomState(3)
    for vid in videos:
        od = tmp_path / "oracle" / f"P0{vid}"
        td = tmp_path / "tags" / f"P0{vid}"
        od.mkdir(parents=True)
        td.mkdir(parents=True)
        (od / "Car_Tree_oracle.txt").write_text("1\n3\n")
        (od / "Cupglass_Sky_oracle.txt").write_text("2\n4\n5\n")
        (td / f"P0{vid}.txt").write_text(
            "Car,Sky\nTree\nCar,Tree\nSky\nCupglass\nTree,Sky\n")
        np.savez(tmp_path / f"P0{vid}.npz",
                 seg_len=np.array([3, 1, 2] + [0] * (segs - 3)),
                 feat_concept1=rs.randn(segs, shots, width).astype(np.float32),
                 feat_concept2=rs.randn(segs, shots, width).astype(np.float32),
                 feat_oracle=rs.randn(segs, shots, width).astype(np.float32))
    cell = np.empty((len(videos), 1), object)
    for i in range(len(videos)):
        cell[i, 0] = (rs.rand(segs * shots, 3) > 0.5).astype(np.uint8)
    scipy.io.savemat(tmp_path / "Tags.mat", {"Tags": cell})


def _features(tmp_path, videos):
    out = {}
    for vid in videos:
        with np.load(tmp_path / f"P0{vid}.npz") as z:
            out[str(vid)] = {k: z[k] for k in z.files}
    return out


def _datasets(tmp_path, videos, segs=8, shots=4):
    feats = _features(tmp_path, videos)
    return [mod.QFVSDataset(str(tmp_path / "oracle"), str(tmp_path / "tags"),
                            list(videos), feats, max_segment_num=segs,
                            max_frame_num=shots)
            for mod in (tqfvs_data, jqfvs_data)]


def test_qfvs_data_matches_jax(tmp_path):
    _write_qfvs_files(tmp_path)
    got, ref = _datasets(tmp_path, (1, 2))
    assert got.items == ref.items and len(ref) == 4
    for i in range(len(ref) + 1):
        g, r = got[i], ref[i]
        assert g.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v, err_msg=k)
                assert g[k].dtype == v.dtype, k
            else:
                assert g[k] == v, k
    assert tqfvs_data.QFVSDataset.prompts("Cupglass", "Petsanimal") == \
        jqfvs_data.QFVSDataset.prompts("Cupglass", "Petsanimal")
    for a, b in zip(tqfvs_data.load_videos_tag(str(tmp_path / "Tags.mat")),
                    jqfvs_data.load_videos_tag(str(tmp_path / "Tags.mat"))):
        np.testing.assert_array_equal(a, b)
    flat = np.arange(60, dtype=np.float32).reshape(15, 4)
    for bounds in ([2, 4], [3, 9, 12], [0, 40]):
        for a, b in zip(tqfvs_data.pack_shot_features(flat, bounds, 4, 3),
                        jqfvs_data.pack_shot_features(flat, bounds, 4, 3)):
            np.testing.assert_array_equal(a, b)


def test_selection_and_matching_f1_match_jax():
    rs = np.random.RandomState(5)
    tags = (rs.rand(40, 6) > 0.6).astype(np.uint8)
    for seed in range(3):
        r = np.random.RandomState(seed)
        scores = r.randn(4, 10).astype(np.float32)
        mask = (np.arange(10)[None] < np.array([[10], [7], [3], [0]]))
        mask = mask.astype(np.float32)
        sel = tqfvs.top_percent_shots(scores, mask, 0.2)
        np.testing.assert_array_equal(
            sel, jqfvs.top_percent_shots(scores, mask, 0.2))
        gt = np.sort(r.choice(20, 5, replace=False))
        assert tqfvs.semantic_matching_f1(sel, gt, tags) == \
            jqfvs.semantic_matching_f1(sel, gt, tags)
    a, b = tags[:5].astype(np.float64), tags[5:9].astype(np.float64)
    np.testing.assert_array_equal(tqfvs.semantic_iou_matrix(a, b),
                                  jqfvs.semantic_iou_matrix(a, b))
    np.testing.assert_array_equal(tqfvs.sinusoid_positions(20, D_MODEL),
                                  jqfvs.sinusoid_positions(20, D_MODEL))


# ---------------- the scorer ----------------


def _batch(seed, b=2, segs=3, shots=6):
    rs = np.random.RandomState(seed)
    seg_len = np.array([[6, 3, 0], [2, 6, 1]][:b], np.int32)
    mask = (np.arange(shots)[None, None] < seg_len[..., None]).astype(np.float32)
    out = {"seg_len": seg_len, "mask": mask}
    for key in ("concept1", "concept2", "oracle"):
        out[f"feat_{key}"] = rs.randn(b, segs, shots, D_MODEL).astype(np.float32)
        out[f"{key}_GT"] = (rs.rand(b, segs, shots) > 0.5).astype(np.float32)
    return out


def _models(seed=0):
    jm = jqfvs.SummaryScorer(d_model=D_MODEL)
    b = _batch(0)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(b["feat_oracle"]),
                     jnp.asarray(b["seg_len"]))["params"]
    params = perturb(params, seed)
    tm = tqfvs.SummaryScorer(d_model=D_MODEL)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, _no_dropout(tm).train()


def test_scorer_logits_loss_and_every_gradient_match_jax():
    """From one flax tree (bridged both ways; a segment of no shots, whose
    keys are all masked): the logits, the BCE and every gradient."""
    jm, params, tm = _models()
    batch = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        logits = jm.apply({"params": p}, jb["feat_oracle"], jb["seg_len"])
        return jqfvs.qfvs_bce_loss(logits, jb["oracle_GT"], jb["mask"]), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    back = flax_from_state_dict(tm.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tb = {k: _t(v) for k, v in batch.items()}
    logits = tm(tb["feat_oracle"], tb["seg_len"])
    assert_close_by_max(logits, ref_logits)
    got = tqfvs.qfvs_bce_loss(logits, tb["oracle_GT"], tb["mask"])
    np.testing.assert_allclose(got.item(), float(ref_loss), rtol=1e-4)
    got.backward()
    assert_grads_match(tm, ref_grads)


def test_three_steps_match_optax(flax_without_dropout):
    """AdamW (decay 1e-5 on every parameter) at optax's cosine rate over 4
    steps, the loss over concept1, concept2 and oracle: the JAX runner's
    step and the port's on three batches."""
    jm, params, tm = _models(seed=2)
    kw = dict(lr=1e-3, total_steps=4)
    tx, jstep, _ = jrunners.make_qfvs_train_step(jm, **kw)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32),
                       jax.random.PRNGKey(1))
    optimizer, scheduler, step, score = trunners.make_qfvs_train_step(
        tm, generator=torch.Generator().manual_seed(0), **kw)
    assert optimizer.param_groups[0]["weight_decay"] == 1e-5
    grads, rates = [], []
    for i in range(3):
        batch = _batch(10 + i)
        rates.append(scheduler.get_last_lr()[0])
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(batch)
        np.testing.assert_allclose(got["loss_total"].item(),
                                   float(ref["loss_total"]), rtol=2e-4)
        grads.append({n: (p.grad, p.grad) for n, p in tm.named_parameters()})
    sched = jax.jit(lambda c: jnp.float32(1e-3) * 0.5 * (1 + jnp.cos(
        jnp.pi * jnp.minimum(c, 4) / 4)))
    np.testing.assert_allclose(rates, [float(sched(c)) for c in range(3)],
                               rtol=1e-6)
    assert_steps_match(tm, state.params, grads, sum(rates))
    batch = _batch(20)
    ref = jm.apply({"params": state.params}, jnp.asarray(batch["feat_oracle"]),
                   jnp.asarray(batch["seg_len"]))
    assert_close_by_max(score(_t(batch["feat_oracle"]), _t(batch["seg_len"])),
                        ref, tol=2e-3)


# ---------------- run_qfvs ----------------


def test_run_qfvs_matches_jax(tmp_path, monkeypatch, flax_without_dropout):
    """`run_qfvs` of both packages on the same items (two training videos,
    one held out), the port from the JAX run's initial parameters (its
    `init_head_state` patched to load them) and dropout 0 on both sides:
    the same F1."""
    _write_qfvs_files(tmp_path, videos=(1, 2, 3))
    ref_ds = _datasets(tmp_path, (1, 2))[1]
    test_items = [it for it in (_datasets(tmp_path, (3,))[1][i]
                                for i in range(2))]
    tags = jqfvs_data.load_videos_tag(str(tmp_path / "Tags.mat"))[2]
    init = {}
    real_init = jrunners.init_head_state

    def keep(model, tx, args, seed=0):
        state = real_init(model, tx, args, seed)
        init["params"] = jax.device_get(state.params)
        return state

    monkeypatch.setattr(jrunners, "init_head_state", keep)
    ref = jorch.run_qfvs(ref_ds, test_items, tags, epochs=2, lr=1e-3,
                         top_percent=0.3)

    def bridged(model, seed=0):
        model.load_state_dict(state_dict_from_flax(init["params"]),
                              strict=True)
        _no_dropout(model)
        return torch.Generator().manual_seed(seed + 1)

    monkeypatch.setattr(trunners, "init_head_state", bridged)
    timings = {}
    got = torch_orch.run_qfvs(_datasets(tmp_path, (1, 2))[0], test_items,
                              tags, epochs=2, lr=1e-3, top_percent=0.3,
                              device="cpu", timings=timings)
    assert got == pytest.approx(ref, abs=1e-9) and set(got) == {"F1"}
    assert {k: len(v) for k, v in timings.items()} == {"step": 8, "infer": 2}
