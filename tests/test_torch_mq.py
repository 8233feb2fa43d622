"""The EgoMQ slice of egovlpv2_torch against egovlpv2_tpu on the CPU, f32:
the copies free of JAX (`mq_eval`, `mq_data`, `sweep`, the MQ dataset) on
the fixtures of the JAX tests; VSGN's anchors, matching, kNN and
transposed convolution; the model's outputs, loss parts and every gradient
from the same parameters (through the weight bridge, both ways); three
steps of its Adam + StepLR against optax; inference and proposals; and
`run_egomq` end to end on the same files from the same initial parameters.

Tolerances: outputs, loss parts and gradients within 1e-4 of the largest
|reference| of each tensor (f32 sums in another order); parameters after
three steps within 2e-4 (of |param| where that is above 1); kNN indices,
matches and targets' labels equal."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.downstream import datasets as jdatasets
from egovlpv2_tpu.downstream import mq_data as jmq_data
from egovlpv2_tpu.downstream import mq_eval as jmq_eval
from egovlpv2_tpu.downstream import mq_infer as jmq_infer
from egovlpv2_tpu.downstream import runners as jrunners
from egovlpv2_tpu.downstream import sweep as jsweep
from egovlpv2_tpu.downstream import vsgn as jvsgn
from egovlpv2_tpu.tasks import orchestrators as jorch
from egovlpv2_torch.downstream import datasets as tdatasets
from egovlpv2_torch.downstream import mq_data as tmq_data
from egovlpv2_torch.downstream import mq_eval as tmq_eval
from egovlpv2_torch.downstream import mq_infer as tmq_infer
from egovlpv2_torch.downstream import runners as trunners
from egovlpv2_torch.downstream import sweep as tsweep
from egovlpv2_torch.downstream import vsgn as tvsgn
from egovlpv2_torch.tasks import orchestrators as torch_orch
from egovlpv2_torch.weights import flax_from_state_dict, state_dict_from_flax
from tests.test_downstream import _write_mq_fixture
from torch_parity import (assert_close_by_max, assert_grads_match,
                          assert_init_like_flax, assert_steps_match, perturb)

torch.set_num_threads(2)

# The small VSGN of these tests: input 64, hidden 64 (two channels a
# GroupNorm group, so a conv bias ahead of it has a gradient), T = 64,
# 3 levels, 5 classes.
SMALL = dict(input_feat_dim=64, hidden_dim=64, num_levels=3,
             temporal_scale=64, num_classes=5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------- the copies free of JAX ----------------


def _mq_entries(seed, n_gt=12, n_pred=40):
    rs = np.random.RandomState(seed)
    gt, pred = [], []
    for i in range(n_gt):
        s = float(rs.uniform(0, 80))
        gt.append({"video_id": f"v{i % 3}", "t_start": s,
                   "t_end": s + float(rs.uniform(1, 15)), "label": i % 4})
    for i in range(n_pred):
        s = float(rs.uniform(0, 80))
        pred.append({"video_id": f"v{i % 3}", "t_start": s,
                     "t_end": s + float(rs.uniform(1, 15)), "label": i % 4,
                     "score": float(rs.rand())})
    return gt, pred


def test_mq_eval_matches_jax():
    for seed in range(3):
        gt, pred = _mq_entries(seed)
        assert tmq_eval.detection_map(gt, pred, (0.1, 0.3, 0.5)) == \
            jmq_eval.detection_map(gt, pred, (0.1, 0.3, 0.5))
        assert tmq_eval.retrieval_recall(gt, pred) == \
            jmq_eval.retrieval_recall(gt, pred)
        np.testing.assert_array_equal(
            tmq_eval.average_precision_detection(gt, pred),
            jmq_eval.average_precision_detection(gt, pred))
        a = np.array([[p["t_start"], p["t_end"]] for p in pred])
        b = np.array([[g["t_start"], g["t_end"]] for g in gt])
        np.testing.assert_array_equal(tmq_eval.span_iou(a, b),
                                      jmq_eval.span_iou(a, b))
        np.testing.assert_array_equal(tmq_eval.segment_iou(b[0], a),
                                      jmq_eval.segment_iou(b[0], a))
    det = {"c1": [{"label": "cook", "score": 0.5, "segment": [0.0, 1.0]}]}
    assert tmq_eval.pack_submission(det, {}) == jmq_eval.pack_submission(det, {})


def test_mq_data_matches_jax(tmp_path):
    """The conversion fixture of `tests/test_downstream.py`: the same clip
    table, and the same file and counts from `write_clip_annotations`."""
    def label(name, primary=True):
        return {"label": name, "start_time": 1.0, "end_time": 3.0,
                "primary": primary}

    train = {"videos": [
        {"video_uid": "vid1", "split": "train", "clips": [{
            "clip_uid": "c1", "video_start_sec": 0.0, "video_end_sec": 8.0,
            "annotations": [{"labels": [label("cook"),
                                        label("alt", primary=False)]}]}]},
        {"video_uid": "vid2", "split": "train", "clips": [{
            "clip_uid": "missing", "video_start_sec": 0.0,
            "video_end_sec": 8.0,
            "annotations": [{"labels": [label("cook")]}]}]},
        {"video_uid": "vid3", "split": "train", "clips": [{
            "clip_uid": "c3", "video_start_sec": 0.0, "video_end_sec": 8.0,
            "annotations": [{"labels": [label("alt", primary=False)]}]}]},
    ]}
    test = {"videos": [{"video_uid": "vid4", "split": "test", "clips": [{
        "clip_uid": "c4", "video_start_sec": 2.0, "video_end_sec": 10.0}]}]}
    info = {"videos": [{"video_uid": f"vid{i}", "duration_sec": 16.0}
                       for i in (1, 2, 3, 4)]}
    np.save(tmp_path / "c1.npy", np.zeros((32, 4), np.float32))
    torch.save(torch.zeros(24, 4), tmp_path / "c3.pt")
    np.save(tmp_path / "c4.npy", np.zeros((32, 4), np.float32))
    for feature_dir in (str(tmp_path), None):
        assert tmq_data.convert_moment_annotations([train, test], info,
                                                   feature_dir) == \
            jmq_data.convert_moment_annotations([train, test], info,
                                                feature_dir)
    counts = [mod.write_clip_annotations(str(tmp_path / f"{n}.json"),
                                         [train, test], info, str(tmp_path))
              for n, mod in (("t", tmq_data), ("j", jmq_data))]
    assert counts[0] == counts[1] == {"train": 1, "test": 1}
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def _assert_items_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray) or np.isscalar(ref[k]) \
                and not isinstance(ref[k], str):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("kw", [
    dict(temporal_scale=64),
    dict(temporal_scale=64, window_stride=32),
    dict(temporal_scale=64, window_stride=32, mode="inference"),
    dict(temporal_scale=128, use_vss=True, stitch_gap=10),
])
def test_mq_dataset_matches_jax(tmp_path, kw):
    """The long clip of `tests/test_downstream.py` (a moment past the
    truncation point) and a short one for VSS self-stitching, with its .pt
    twin: every item array for array."""
    anno = json.loads(open(_write_mq_fixture(tmp_path)).read())
    rs = np.random.RandomState(1)
    torch.save(torch.from_numpy(rs.randn(20, 8).astype(np.float32)),
               tmp_path / "short.pt")
    anno["short"] = {"subset": "train", "clip_id": "short",
                     "parent_start_sec": 0.0, "parent_end_sec": 10.0,
                     "annotations": [
                         {"start_time": 1.0, "end_time": 4.0, "label": "x"}]}
    path = tmp_path / "anno.json"
    path.write_text(json.dumps(anno))
    args = (str(path), str(tmp_path))
    kw = dict(subset="train", input_feat_dim=8,
              moment_classes=str(tmp_path / "classes.json"), **kw)
    ref = jdatasets.EgoMQFeatureDataset(*args, **kw)
    got = tdatasets.EgoMQFeatureDataset(*args, **kw)
    assert got.items == ref.items and got.classes == ref.classes
    for i in range(len(ref)):
        _assert_items_equal(got[i], ref[i])
    np.testing.assert_array_equal(tdatasets.load_features(str(tmp_path / "short")),
                                  jdatasets.load_features(str(tmp_path / "short")))
    a = np.linspace(0, 1, 9)
    np.testing.assert_array_equal(
        tdatasets.ioa_with_anchors(a[:-1], a[1:], 0.2, 0.55),
        jdatasets.ioa_with_anchors(a[:-1], a[1:], 0.2, 0.55))


def test_sweep_matches_jax(tmp_path):
    grid = {"lr": (0.1, 0.2, 0.3), "gamma": (0.5, 0.9)}
    assert list(tsweep.grid_configs(tsweep.REFERENCE_EGOMQ_GRID)) == \
        list(jsweep.grid_configs(jsweep.REFERENCE_EGOMQ_GRID))

    def run(lr, gamma):
        return {"mAP_avg": 1.0 - (lr - 0.2) ** 2 - (gamma - 0.9) ** 2}

    got = tsweep.grid_sweep(run, grid, out_path=str(tmp_path / "t.json"))
    ref = jsweep.grid_sweep(run, grid, out_path=str(tmp_path / "j.json"))
    assert got == ref
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    seen = []

    def fake_run(clip_anno, feature_path, out_dir, batch_size, lr, epochs):
        seen.append(out_dir)
        return {"mAP_avg": float(batch_size) / (1.0 + lr)}

    best = tsweep.run_egomq_sweep("anno.json", "feats/", str(tmp_path / "s"),
                                  grid={"batch_size": (4, 8), "lr": (0.1,)},
                                  run_fn=fake_run, epochs=1)
    assert best["config"] == {"batch_size": 8, "lr": 0.1} and len(seen) == 2
    assert (tmp_path / "s" / "sweep_results.json").exists()


# ---------------- VSGN pieces ----------------


def test_anchors_boxes_and_targets_match_jax():
    anchors = np.concatenate(jvsgn.make_anchors(64, 3, (1.0, 10.0)))
    for a, b in zip(tvsgn.make_anchors(64, 3, (1.0, 10.0)),
                    jvsgn.make_anchors(64, 3, (1.0, 10.0))):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(2)
    starts = rs.rand(3, 6).astype(np.float32) * 0.8
    gt = np.stack([starts, starts + rs.rand(3, 6).astype(np.float32) * 0.2,
                   rs.randint(1, 5, (3, 6)).astype(np.float32)], axis=-1)
    gt[2, 3] = gt[2, 2]  # two equal boxes: argmax ties
    num_gt = np.array([6, 2, 4], np.int32)
    for thr in (0.5, 0.6):
        ref_cls, ref_reg = jvsgn.prepare_targets(
            jnp.asarray(gt), jnp.asarray(num_gt), jnp.asarray(anchors), 64.0,
            thr)
        cls, reg = tvsgn.prepare_targets(_t(gt), _t(num_gt), _t(anchors),
                                         64.0, thr)
        np.testing.assert_array_equal(cls.numpy(), np.asarray(ref_cls))
        assert (np.asarray(ref_cls) > 0).sum() > 10
        assert_close_by_max(reg, ref_reg)
    enc = rs.randn(len(anchors), 2).astype(np.float32)
    assert_close_by_max(tvsgn.box_decode(_t(enc), _t(anchors)),
                        jvsgn.box_decode(jnp.asarray(enc), jnp.asarray(anchors)))
    iou = rs.rand(7, 4).astype(np.float32)
    iou[:, 2] = iou[:, 1]
    valid = np.array([True, True, True, False])
    for low in (True, False):
        np.testing.assert_array_equal(
            tvsgn.match_anchors(_t(iou), _t(valid), 0.5, low).numpy(),
            np.asarray(jvsgn.match_anchors(jnp.asarray(iou),
                                           jnp.asarray(valid), 0.5, low)))


def _padded_feats(seed, b=3, t=48, c=16, lengths=(48, 12, 30)):
    """Features with zero rows past each length: exactly tied distances."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, t, c).astype(np.float32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("use_vss, t", [(False, 48), (True, 48), (True, 24)])
def test_knn_indices_equal_jax(use_vss, t, monkeypatch):
    """Equal indices, ties (the zero rows) to the lower index as
    `lax.top_k`'s; computed a few rows a block, as on the card."""
    x, n = _padded_feats(3, t=t, lengths=(t, 12, 30 if t > 30 else 20))
    monkeypatch.setattr(tvsgn, "_KNN_BLOCK_ELEMENTS", 3 * t * 16 * 5)
    ref = jvsgn.knn_indices(jnp.asarray(x), 10, jnp.asarray(n), 48, 30, 0.4,
                            use_vss)
    got = tvsgn.knn_indices(_t(x), 10, _t(n), 48, 30, 0.4, use_vss)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int64


def test_conv_transpose_matches_flax():
    """flax's ConvTranspose(3, strides=2, "SAME") through the bridge: the
    taps reversed, the first 2T outputs."""
    from flax import linen as nn

    rs = np.random.RandomState(4)
    for t in (7, 8):
        x = rs.randn(2, t, 6).astype(np.float32)
        layer = nn.ConvTranspose(5, (3,), strides=(2,), padding="SAME")
        params = perturb(layer.init(jax.random.PRNGKey(0), x)["params"], 1)
        ref = np.asarray(layer.apply({"params": params}, x))
        mod = tvsgn.ConvTransposeSame(6, 5)
        sd = state_dict_from_flax({"dec_0": params})
        mod.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
        got = mod(_t(x))
        assert got.shape == ref.shape == (2, 2 * t, 5)
        assert_close_by_max(got, ref)


# ---------------- the model ----------------


def _batch(seed, b=2, t=64, c=64, lengths=(64, 20), classes=5):
    rs = np.random.RandomState(seed)
    video = rs.randn(b, t, c).astype(np.float32)
    for i, n in enumerate(lengths):
        video[i, n:] = 0.0
    starts = rs.rand(b, 5).astype(np.float32) * 0.7
    gt = np.stack([starts, starts + 0.05 + rs.rand(b, 5).astype(np.float32)
                   * 0.25, rs.randint(1, classes, (b, 5)).astype(np.float32)],
                  axis=-1)
    return {"video": video, "num_frms": np.asarray(lengths, np.int32),
            "gt_bbox": gt, "num_gt": np.asarray([3, 2][:b], np.int32),
            "gt_action": (rs.rand(b, t) > 0.6).astype(np.float32),
            "gt_start": rs.rand(b, t).astype(np.float32),
            "gt_end": rs.rand(b, t).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _flax_init(seed):
    b = _batch(0)
    return jax.jit(jvsgn.VSGN(**SMALL).init)(
        jax.random.PRNGKey(seed), jnp.asarray(b["video"]),
        jnp.asarray(b["num_frms"]))["params"]


def _models(seed=0):
    jm = jvsgn.VSGN(**SMALL)
    params = perturb(_flax_init(seed), seed)
    tm = tvsgn.VSGN(**SMALL)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm


def _jloss(jm, batch):
    anchors = jnp.concatenate([jnp.asarray(a) for a in jvsgn.make_anchors(
        jm.temporal_scale, jm.num_levels, jm.anchor_scales)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        out = jm.apply({"params": params}, jb["video"], jb["num_frms"])
        parts = jvsgn.vsgn_losses(
            out, anchors, len(jm.anchor_scales), jm.num_classes,
            float(jm.temporal_scale), jb["gt_bbox"], jb["num_gt"],
            jb["gt_action"], jb["gt_start"], jb["gt_end"])
        return parts["loss_total"], (parts, out)

    return loss


def test_vsgn_outputs_losses_and_every_gradient_match_jax():
    """From one flax tree (bridged both ways, VSS on, one short video):
    every output, every loss part and every parameter's gradient."""
    jm, params, tm = _models()
    batch = _batch(1)
    (ref_total, (ref_parts, ref_out)), ref_grads = jax.jit(jax.value_and_grad(
        _jloss(jm, batch), has_aux=True))(params)
    back = flax_from_state_dict(tm.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))

    tb = {k: _t(v) for k, v in batch.items()}
    out = tm(tb["video"], tb["num_frms"])
    for key, ref in ref_out.items():
        if isinstance(ref, list):
            assert len(out[key]) == len(ref)
            for g, r in zip(out[key], ref):
                assert_close_by_max(g, r, err_msg=key)
        else:
            assert_close_by_max(out[key], ref, err_msg=key)
    parts = tvsgn.vsgn_losses(out, tm.anchors, 2, 5, 64.0, tb["gt_bbox"],
                              tb["num_gt"], tb["gt_action"], tb["gt_start"],
                              tb["gt_end"])
    assert parts.keys() == ref_parts.keys()
    for key, ref in ref_parts.items():
        np.testing.assert_allclose(parts[key].item(), float(ref), rtol=1e-4,
                                   err_msg=key)
    parts["loss_total"].backward()
    assert_grads_match(tm, ref_grads)


def test_init_head_state_draws_as_flax():
    """The port's own initialisation (`runners.init_head_state`): each
    parameter from flax's default initialiser's distribution (lecun-normal
    convolutions and transposed convolutions, zero biases, unit GroupNorm
    scales), against flax's init of the same model; a dropout generator."""
    model = tvsgn.VSGN(**SMALL)
    generator = trunners.init_head_state(model, seed=3)
    assert isinstance(generator, torch.Generator)
    assert_init_like_flax(model, _flax_init(0))


def test_three_steps_match_optax():
    """Adam with L2 (optax `add_decayed_weights` then `adam`) and the
    staircase StepLR (halved after every step here): the JAX runner's step
    and the port's on three batches, losses and parameters."""
    jm, params, tm = _models(seed=2)
    kw = dict(lr=1e-3, step_size=1, gamma=0.5, steps_per_epoch=1)
    tx, _, jstep, _ = jrunners.make_vsgn_train_step(jm, **kw)
    from egovlpv2_tpu.train.step import TrainState

    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32),
                       jax.random.PRNGKey(1))
    optimizer, scheduler, step, _ = trunners.make_vsgn_train_step(tm, **kw)
    assert optimizer.param_groups[0]["weight_decay"] == 1e-4
    grads = []
    for i in range(3):
        batch = _batch(10 + i)
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        got = step(batch)
        np.testing.assert_allclose(got["loss_total"].item(),
                                   float(ref["loss_total"]), rtol=2e-4)
        assert scheduler.get_last_lr()[0] == pytest.approx(1e-3 * 0.5 ** (i + 1))
        # Adam's input: the gradient and the L2 term
        grads.append({n: (p.grad, p.grad + 1e-4 * before[n])
                      for n, p in tm.named_parameters()})
    assert_steps_match(tm, state.params, grads, 1e-3 * (1 + 0.5 + 0.25))
    start = state_dict_from_flax(params)
    assert all(not torch.equal(p.detach(), start[n])
               for n, p in tm.named_parameters())


def test_predict_and_proposals_match_jax():
    jm, params, tm = _models(seed=3)
    batch = _batch(5, b=1, lengths=(50,))
    probs, adjusted, start, end = jmq_infer.make_vsgn_predict(jm)(
        params, jnp.asarray(batch["video"]), jnp.asarray(batch["num_frms"]))
    got = tmq_infer.make_vsgn_predict(tm)(_t(batch["video"]),
                                          _t(batch["num_frms"]))
    for g, r in zip(got, (probs, adjusted, start, end)):
        assert_close_by_max(g, r)
    # the host's part from the same arrays: the same proposals
    arrays = [np.asarray(a[0]) for a in (probs, adjusted, start, end)]
    kw = dict(num_frms=50, fps=2.0, clip_id="c", temporal_scale=64,
              offset_sec=3.0)
    ref = jmq_infer.proposals_from_outputs(*arrays, **kw)
    assert tmq_infer.proposals_from_outputs(*arrays, **kw) == ref and ref
    dets = np.array([[0.0, 10.0, 0.9], [1.0, 9.0, 0.5], [20.0, 30.0, 0.8]])
    assert tmq_infer.nms_1d(dets, 0.4) == jmq_infer.nms_1d(dets, 0.4)


# ---------------- run_egomq ----------------


def _write_mq_files(tmp_path):
    """The clips of `tests/test_orchestrators.py`: two train, one val."""
    rs = np.random.RandomState(0)
    anno = {}
    for split, names in (("train", ["a", "b"]), ("val", ["c"])):
        for name in names:
            np.save(tmp_path / f"{name}.npy", rs.randn(40, 8).astype(np.float32))
            anno[name] = {
                "subset": split, "clip_id": name,
                "parent_start_sec": 0.0, "parent_end_sec": 20.0,
                "annotations": [
                    {"start_time": 2.0, "end_time": 6.0, "label": "cook"},
                    {"start_time": 10.0, "end_time": 14.0, "label": "clean"},
                ],
            }
    path = tmp_path / "anno.json"
    path.write_text(json.dumps(anno))
    return str(path)


def test_run_egomq_matches_jax(tmp_path, monkeypatch):
    """`run_egomq` of both packages on the same files, the port from the
    JAX run's initial parameters (its `init_head_state` patched to load
    them): the metrics within 1e-6 (the same proposals, up to scores within
    1e-4 of each other), and the three json files with the same clips,
    labels and segments, scores within 1e-4."""
    anno = _write_mq_files(tmp_path)
    kw = dict(epochs=2, batch_size=2, temporal_scale=64, input_feat_dim=8,
              num_levels=3, tiou_thresholds=(0.1, 0.5))
    init = {}
    real_init = jrunners.init_head_state

    def keep(model, tx, args, seed=0):
        state = real_init(model, tx, args, seed)
        init["params"] = jax.device_get(state.params)
        return state

    monkeypatch.setattr(jrunners, "init_head_state", keep)
    ref = jorch.run_egomq(anno, str(tmp_path), str(tmp_path / "j"), **kw)

    def bridged(model, seed=0):
        model.load_state_dict(state_dict_from_flax(init["params"]),
                              strict=True)
        return torch.Generator().manual_seed(seed + 1)

    monkeypatch.setattr(trunners, "init_head_state", bridged)
    timings = {}
    got = torch_orch.run_egomq(anno, str(tmp_path), str(tmp_path / "t"),
                               device="cpu", timings=timings, **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert {k: len(v) for k, v in timings.items()} == \
        {"step": 2, "infer": 1, "proposals": 1}
    for name in ("detections_postNMS.json", "retreival_postNMS.json",
                 "submission.json", "moment_classes.json"):
        g = json.loads((tmp_path / "t" / name).read_text())
        r = json.loads((tmp_path / "j" / name).read_text())
        assert g.keys() == r.keys(), name
        if name == "moment_classes.json":
            assert g == r
            continue
        results = [("results", g["results"], r["results"])] \
            if "results" in g else \
            [(k, g[k], r[k]) for k in ("detect_results", "retrieve_results")]
        for what, gm, rm in results:
            assert gm.keys() == rm.keys() == {"c"}, (name, what)
            assert len(gm["c"]) == len(rm["c"]) > 0
            for a, b in zip(sorted(gm["c"], key=lambda p: (p["label"],
                                                            p["segment"])),
                            sorted(rm["c"], key=lambda p: (p["label"],
                                                            p["segment"]))):
                assert (a["label"], a["segment"]) == (b["label"], b["segment"])
                assert a["score"] == pytest.approx(b["score"], abs=1e-4)
