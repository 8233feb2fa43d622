"""The EgoNLQ slice of egovlpv2_torch against egovlpv2_tpu on the CPU, f32:
the copies free of JAX (`nlq_eval`, `nlq_data`, the NLQ dataset and its
highlight labels); VSLNet's outputs, loss parts and every gradient from
the same parameters (through the weight bridge, both ways) at dim 32, 4
heads, `max_pos_len` 32, dropout 0; its top spans; three steps of its two
AdamW groups and warmup-linear rate against optax; and `run_egonlq` end
to end on the same files from the same initial parameters, dropout 0 on
both sides.

Tolerances: outputs, loss parts and gradients within 1e-4 of the largest
|reference| of each tensor (f32 sums in another order); parameters after
three steps within 2e-4 (of |param| where that is above 1); span indices
and the end-to-end metrics equal."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.downstream import datasets as jdatasets
from egovlpv2_tpu.downstream import nlq_data as jnlq_data
from egovlpv2_tpu.downstream import nlq_eval as jnlq_eval
from egovlpv2_tpu.downstream import runners as jrunners
from egovlpv2_tpu.downstream import vslnet as jvslnet
from egovlpv2_tpu.tasks import orchestrators as jorch
from egovlpv2_tpu.train.step import TrainState
from egovlpv2_torch.downstream import datasets as tdatasets
from egovlpv2_torch.downstream import nlq_data as tnlq_data
from egovlpv2_torch.downstream import nlq_eval as tnlq_eval
from egovlpv2_torch.downstream import runners as trunners
from egovlpv2_torch.downstream import vslnet as tvslnet
from egovlpv2_torch.models.dropout import Dropout
from egovlpv2_torch.tasks import orchestrators as torch_orch
from egovlpv2_torch.weights import flax_from_state_dict, state_dict_from_flax
from torch_parity import (assert_close_by_max, assert_grads_match,
                          assert_init_like_flax, assert_steps_match, perturb)

torch.set_num_threads(2)

SMALL = dict(dim=32, num_heads=4, max_pos_len=32, video_feature_dim=24,
             query_feature_dim=20, drop_rate=0.0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------- the copies free of JAX ----------------


def test_nlq_eval_matches_jax():
    rs = np.random.RandomState(0)
    pred = np.sort(rs.rand(7, 2) * 30, axis=1)
    gt = np.sort(rs.rand(3, 2) * 30, axis=1)
    np.testing.assert_array_equal(tnlq_eval.compute_iou(pred, gt),
                                  jnlq_eval.compute_iou(pred, gt))
    truth = {("c", "a", i): tuple(gt[i]) for i in range(3)}
    preds = [{"clip_uid": "c", "annotation_uid": "a", "query_idx": i,
              "predicted_times": (np.sort(rs.rand(5, 2) * 30, 1)).tolist()}
             for i in range(3)]
    got, ref = tnlq_eval.evaluate_nlq(preds, truth), \
        jnlq_eval.evaluate_nlq(preds, truth)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
    for s, e, n, d in ((3.0, 9.0, 20, 20.0), (10.0, 20.0, 100, 100.0)):
        a, b = tnlq_eval.time_to_index(s, e, n, d), \
            jnlq_eval.time_to_index(s, e, n, d)
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        assert tnlq_eval.index_to_time(a[0], a[1], n, d) == \
            jnlq_eval.index_to_time(b[0], b[1], n, d)


def _write_nlq_files(tmp_path, n=8, windows=20, width=12):
    """The official NLQ json layout and the extractor's dumps, as
    `tests/test_cli_downstream.py` writes them: `n` clips of one query."""
    rs = np.random.RandomState(1)
    videos = []
    for i in range(n):
        clip = f"clip{i}"
        np.save(tmp_path / f"{clip}_ann{i}_0.npy",
                rs.randn(windows, width).astype(np.float32))
        np.save(tmp_path / f"{clip}_ann{i}_0_query.npy",
                rs.randn(5, width).astype(np.float32))
        start = float(rs.uniform(0, 12))
        videos.append({"video_uid": f"vid{i}", "clips": [{
            "clip_uid": clip, "video_start_sec": 0.0, "video_end_sec": 20.0,
            "annotations": [{"annotation_uid": f"ann{i}", "language_queries": [
                {"query": f"Where is object {i} ", "clip_start_sec": start,
                 "clip_end_sec": start + float(rs.uniform(1, 7))},
                None, {"query": ""}]}]}]})
    train, val = tmp_path / "nlq_train.json", tmp_path / "nlq_val.json"
    train.write_text(json.dumps({"videos": videos[:6]}))
    val.write_text(json.dumps({"videos": videos[6:]}))
    return str(train), str(val)


def test_nlq_data_and_dataset_match_jax(tmp_path):
    train, _ = _write_nlq_files(tmp_path, windows=40)
    for annotated in (True, False):
        assert tnlq_data.load_nlq_annotations(train, annotated) == \
            jnlq_data.load_nlq_annotations(train, annotated)
    records = jnlq_data.load_nlq_annotations(train)
    counts = {f"clip{i}": 40 for i in range(5)}
    meta = tnlq_data.attach_feature_indices(records, counts)
    assert meta == jnlq_data.attach_feature_indices(records, counts)
    assert len(meta) == 5
    got = tdatasets.NLQFeatureDataset(meta, str(tmp_path), max_pos_len=32)
    ref = jdatasets.NLQFeatureDataset(meta, str(tmp_path), max_pos_len=32)
    for i in range(len(ref)):
        g, r = got[i], ref[i]
        assert g.keys() == r.keys() and g["meta"] == r["meta"]
        for k in ("video_features", "v_mask", "query_features", "s_ind",
                  "e_ind"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype
    s, e = np.array([0, 5, 20, 28]), np.array([3, 5, 31, 31])
    np.testing.assert_array_equal(tdatasets.nlq_highlight_labels(s, e, 32),
                                  jdatasets.nlq_highlight_labels(s, e, 32))


# ---------------- the model ----------------


def _batch(seed, b=3, sv=32, sq=7):
    rs = np.random.RandomState(seed)
    v_mask = np.zeros((b, sv), np.int32)
    q_mask = np.zeros((b, sq), np.int32)
    for i, (nv, nq) in enumerate(zip((sv, 20, 11), (sq, 4, 6))):
        v_mask[i, :nv], q_mask[i, :nq] = 1, 1
    s_ind = np.array([2, 4, 1], np.int32)
    e_ind = np.array([9, 12, 8], np.int32)
    return {"video_features": rs.randn(b, sv, 24).astype(np.float32),
            "v_mask": v_mask,
            "query_features": rs.randn(b, sq, 20).astype(np.float32),
            "q_mask": q_mask, "s_ind": s_ind, "e_ind": e_ind,
            "h_labels": jdatasets.nlq_highlight_labels(s_ind, e_ind, sv)}


@functools.lru_cache(maxsize=None)
def _flax_init(seed):
    b = _batch(0)
    return jax.jit(jvslnet.VSLNet(**SMALL).init)(
        jax.random.PRNGKey(seed), *(jnp.asarray(b[k]) for k in (
            "video_features", "v_mask", "query_features", "q_mask")))["params"]


def _models(seed=0):
    jm = jvslnet.VSLNet(**SMALL)
    params = perturb(_flax_init(seed), seed)
    tm = tvslnet.VSLNet(**SMALL)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm.train()


def _jloss(jm, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        h, s, e = jm.apply({"params": params}, jb["video_features"],
                           jb["v_mask"], jb["query_features"], jb["q_mask"])
        hl = jvslnet.HighLightLayer.loss(h, jb["h_labels"], jb["v_mask"])
        span = jvslnet.span_loss(s, e, jb["s_ind"], jb["e_ind"])
        return span + 5.0 * hl, (span, hl, h, s, e)

    return loss


def test_vslnet_outputs_losses_and_every_gradient_match_jax():
    """From one flax tree (bridged both ways; padded videos and queries):
    the highlight scores, start and end logits (the masked ones at -1e30),
    both losses and every parameter's gradient; and the top spans."""
    jm, params, tm = _models()
    batch = _batch(1)
    (ref_loss, (span, hl, h, s, e)), ref_grads = jax.jit(jax.value_and_grad(
        _jloss(jm, batch), has_aux=True))(params)
    back = flax_from_state_dict(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))

    tb = {k: _t(v) for k, v in batch.items()}
    got_h, got_s, got_e = tm(tb["video_features"], tb["v_mask"],
                             tb["query_features"], tb["q_mask"])
    assert_close_by_max(got_h, h)
    live = batch["v_mask"].astype(bool)
    for got, ref in ((got_s, s), (got_e, e)):
        assert_close_by_max(got[_t(live)], np.asarray(ref)[live])
        assert (got[_t(~live)] < -1e29).all()
    got_hl = tvslnet.HighLightLayer.loss(got_h, tb["h_labels"], tb["v_mask"])
    got_span = tvslnet.span_loss(got_s, got_e, tb["s_ind"], tb["e_ind"])
    np.testing.assert_allclose(got_span.item(), float(span), rtol=1e-4)
    np.testing.assert_allclose(got_hl.item(), float(hl), rtol=1e-4)
    (got_span + 5.0 * got_hl).backward()
    assert_grads_match(tm, ref_grads)

    starts, ends = jvslnet.extract_top_spans(s, e, k=5)
    got = tvslnet.extract_top_spans(got_s.detach(), got_e.detach(), k=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(starts))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ends))
    # equal scores go to the lower flat index, as lax.top_k's
    flat = torch.zeros(1, 8)
    got = tvslnet.extract_top_spans(flat, flat, k=5)
    ref = jvslnet.extract_top_spans(jnp.zeros((1, 8)), jnp.zeros((1, 8)), k=5)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_init_head_state_draws_as_flax():
    """The port's own initialisation: lecun-normal Dense and depthwise
    convolutions, Embed normal with variance 1 / features, xavier-uniform
    `w4C`, `w4Q`, `w4mlu` and `pool_weight`, unit LayerNorm scales, zero
    biases, against flax's init of the same model; the dropout generator
    set on the model."""
    model = tvslnet.VSLNet(**SMALL)
    generator = trunners.init_head_state(model, seed=3)
    assert model.dropout.generator is generator
    assert_init_like_flax(model, _flax_init(0))


def test_three_steps_match_optax():
    """The JAX runner's two AdamW groups (`_no_decay_mask` over the flax
    paths) and warmup-linear rate, 0 at the first update, against the
    port's on three batches: losses and parameters."""
    jm, params, tm = _models(seed=2)
    kw = dict(lr=1e-3, num_train_steps=4)
    make_tx, make_step, _ = jrunners.make_vslnet_train_step(jm, **kw)
    tx = make_tx(params)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32),
                       jax.random.PRNGKey(1))
    jstep = make_step(tx)
    optimizer, scheduler, step, _ = trunners.make_vslnet_train_step(tm, **kw)
    decays = {id(p) for p in optimizer.param_groups[0]["params"]}
    want = state_dict_from_flax(jrunners._no_decay_mask(params))
    for name, p in tm.named_parameters():
        assert (id(p) in decays) == bool(want[name]), name
    assert [g["weight_decay"] for g in optimizer.param_groups] == [0.01, 0.0]
    named = dict(tm.named_parameters())
    assert id(named["feature_encoder.conv_block.ln.0.weight"]) in decays
    assert id(named["start_layer_norm.weight"]) not in decays
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    grads = []
    for i in range(3):
        batch = _batch(10 + i)
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(batch)
        np.testing.assert_allclose(got["loss_total"].item(),
                                   float(ref["loss_total"]), rtol=2e-4)
        if i == 0:  # lr 0 at the first update: nothing moves
            assert all(torch.equal(p, start[n])
                       for n, p in tm.named_parameters())
        grads.append({n: (p.grad, p.grad) for n, p in tm.named_parameters()})
    factor = trunners.warmup_linear_factor(4, 0.0)
    assert [factor(c) for c in range(5)] == [0.0, 1.0, 2 / 3, 1 / 3, 0.0]
    assert_steps_match(tm, state.params, grads, 1e-3 * (0 + 1 + 2 / 3))
    assert any(not torch.equal(p.detach(), start[n])
               for n, p in tm.named_parameters())


# ---------------- run_egonlq ----------------


def test_run_egonlq_matches_jax(tmp_path, monkeypatch):
    """`run_egonlq` of both packages on the same files (the layout `cli nlq`
    reads), the port from the JAX run's initial parameters (flax's init of
    the same model, seed 0, bridged; its `init_head_state` patched to load
    them) and dropout 0 on both sides: the same metrics."""
    train, val = _write_nlq_files(tmp_path)
    records = jnlq_data.load_nlq_annotations(train) + \
        jnlq_data.load_nlq_annotations(val)
    meta = jnlq_data.attach_feature_indices(
        records, {r["clip_uid"]: 20 for r in records})
    truth = {(r["clip_uid"], r["annotation_uid"], r["query_idx"]):
             (r["s_time"], r["e_time"]) for r in meta[6:]}
    kw = dict(epochs=2, batch_size=2, max_pos_len=24, video_feature_dim=12)
    model = functools.partial(jvslnet.VSLNet, drop_rate=0.0)
    monkeypatch.setattr(jvslnet, "VSLNet", model)
    ref = jorch.run_egonlq(meta[:6], meta[6:], str(tmp_path), truth, **kw)
    x = [jnp.zeros((1, 24, 12)), jnp.ones((1, 24), jnp.int32),
         jnp.zeros((1, 5, 12)), jnp.ones((1, 5), jnp.int32)]
    params = model(max_pos_len=24, video_feature_dim=12).init(
        jax.random.PRNGKey(0), *x)["params"]

    def bridged(m, seed=0):
        m.load_state_dict(state_dict_from_flax(params), strict=True)
        for module in m.modules():
            if isinstance(module, Dropout):
                module.rate = 0.0
        return torch.Generator().manual_seed(seed + 1)

    monkeypatch.setattr(trunners, "init_head_state", bridged)
    timings = {}
    got = torch_orch.run_egonlq(meta[:6], meta[6:], str(tmp_path), truth,
                                device="cpu", timings=timings, **kw)
    assert got == pytest.approx(ref, abs=1e-9) and set(got) == {
        "R1@0.3", "R5@0.3", "R1@0.5", "R5@0.5", "mIoU"}
    assert {k: len(v) for k, v in timings.items()} == {"step": 6, "infer": 2}
