"""End-to-end task orchestrators (port of `egovlpv2_tpu/tasks/orchestrators.py`,
the reference sub-projects' main.py's).

Each function wires head training -> official evaluation for one
downstream benchmark, mirroring:
  * EgoMQ  — `EgoMQ/scripts/train_infer_eval_ego_nce.sh` (Train -> Infer ->
    Eval over extracted features);
  * EgoNLQ — `EgoNLQ/main.py:37-330` (VSLNet training -> evaluate_nlq over
    the extracted features);
  * EgoTaskQA — `EgoTaskQA/main_end2end.py:84-200`;
  * QFVS   — `QFVS/main.py:37-54` (scorer training -> leave-one-out
    bipartite F1).

They run on the card unless `device` says otherwise; on a CUDA device they
set TF32 off for matmuls and cuDNN, so the float32 heads run in full
float32. `timings`, where given, is a dict of lists that a run appends the
host seconds of its work to: "step" for each training step (from its numpy
batch to the end of its device work), "infer" for each inference call (a
window, a query or a test item, to the end of its device work) and, in
EgoMQ, "proposals" for each window's selection and NMS on the host.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from egovlpv2_torch.core.config import ModelConfig


def _device(device) -> torch.device:
    """`device` with TF32 off on a CUDA one: the heads are float32."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _timed(device: torch.device, timings: Optional[Dict[str, List[float]]],
           key: str, fn: Callable, *args, **kwargs):
    """fn(*args, **kwargs), its host seconds to the end of its device work
    appended to timings[key] where timings is given."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.setdefault(key, []).append(time.perf_counter() - t0)
    return out


def _arrays(batch: Dict, skip: str) -> Dict:
    return {k: v for k, v in batch.items() if k != skip}


def run_egomq(
    clip_anno: str,
    feature_path: str,
    out_dir: str,
    epochs: int = 10,
    batch_size: int = 16,
    lr: float = 1e-4,
    step_size: int = 10,
    gamma: float = 0.5,
    temporal_scale: int = 928,
    input_feat_dim: int = 4096,
    num_levels: int = 5,
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
    window_stride: Optional[int] = None,
    use_vss: bool = False,
    device="cuda",
    timings: Optional[Dict[str, List[float]]] = None,
) -> Dict[str, float]:
    """Train VSGN on extracted features, infer proposals, detection mAP.

    `use_vss` reaches the training and validation datasets only: the model
    is built with VSGN's default `use_vss=True`, as the JAX orchestrator
    builds it."""
    from egovlpv2_torch.data.loader import DataLoader
    from egovlpv2_torch.downstream import mq_eval, mq_infer, runners, vsgn
    from egovlpv2_torch.downstream.datasets import EgoMQFeatureDataset
    from egovlpv2_torch.train.step import batch_to_device

    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)

    def dataset(subset, mode, **kw):
        return EgoMQFeatureDataset(
            clip_anno, feature_path, subset=subset, mode=mode,
            temporal_scale=temporal_scale, input_feat_dim=input_feat_dim,
            moment_classes=os.path.join(out_dir, "moment_classes.json"),
            window_stride=window_stride, **kw)

    train_ds = dataset("train", "train", use_vss=use_vss)
    val_ds = dataset("val", "train", use_vss=use_vss)
    num_classes = len(train_ds.classes)
    model = vsgn.VSGN(input_feat_dim=input_feat_dim,
                      temporal_scale=temporal_scale, num_levels=num_levels,
                      num_classes=num_classes, device=device)
    loader = DataLoader(train_ds, batch_size)
    _, _, step, loss_fn = runners.make_vsgn_train_step(
        model, lr=lr, step_size=step_size, gamma=gamma,
        steps_per_epoch=len(loader))
    runners.init_head_state(model)

    def snapshot():
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}

    best_val, best_state = np.inf, snapshot()
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            _timed(device, timings, "step", step, _arrays(batch, "clip_name"))
        # keep best by val loss (EgoMQ/Train.py:54-62)
        val_losses = []
        with torch.no_grad():
            for batch in DataLoader(val_ds, batch_size).epoch(0):
                val_losses.append(float(loss_fn(_arrays(batch,
                                                        "clip_name"))[0]))
        vl = float(np.mean(val_losses)) if val_losses else np.inf
        if vl < best_val:
            best_val, best_state = vl, snapshot()
    model.load_state_dict(best_state)

    # inference + detection mAP
    infer_ds = dataset("val", "inference")
    predict = mq_infer.make_vsgn_predict(model)
    predictions: List[Dict] = []
    ground_truth: List[Dict] = []
    seen_clips = set()
    for i in range(len(infer_ds)):
        item = infer_ds[i]
        t = batch_to_device({"video": item["video"][None],
                             "num_frms": np.asarray([item["num_frms"]])},
                            device)
        probs, adjusted, start, end = _timed(
            device, timings, "infer", predict, t["video"], t["num_frms"])
        predictions += _timed(
            device, timings, "proposals", mq_infer.proposals_from_outputs,
            probs[0].cpu().numpy(), adjusted[0].cpu().numpy(),
            start[0].cpu().numpy(), end[0].cpu().numpy(),
            int(item["num_frms"]), float(item["fps"]), item["clip_name"],
            temporal_scale, offset_sec=float(item["offset_sec"]))
        if item["clip_name"] in seen_clips:  # windows share one GT set
            continue
        seen_clips.add(item["clip_name"])
        for ann in infer_ds.clips[item["clip_name"]]["annotations"]:
            ground_truth.append({
                "video_id": item["clip_name"],
                "t_start": ann["start_time"], "t_end": ann["end_time"],
                "label": infer_ds.classes[ann["label"]],
            })
    metrics = dict(mq_eval.detection_map(ground_truth, predictions,
                                         tiou_thresholds))

    # retrieval track: per clip keep only GT-present categories, ranked by
    # score, top num_prop across labels (generate_retrieval.py:70-110
    # rm_other_category + sort + cap); then Recall rx @ tIoU
    num_prop = 200
    gt_labels: Dict[str, set] = {}
    for g in ground_truth:
        gt_labels.setdefault(g["video_id"], set()).add(g["label"])
    by_clip: Dict[str, List[Dict]] = {}
    for p in predictions:
        if p["label"] in gt_labels.get(p["video_id"], ()):
            by_clip.setdefault(p["video_id"], []).append(p)
    retrieval_preds: List[Dict] = []
    for clip, props in by_clip.items():
        retrieval_preds += sorted(
            props, key=lambda r: -r["score"])[:num_prop]
    metrics.update(mq_eval.retrieval_recall(ground_truth, retrieval_preds))

    # challenge artifacts (Infer.py writes detections_postNMS.json; the
    # retrieval file keeps the reference's spelling so Merge/Eval tooling
    # pointed at this out_dir finds it; Merge_detection_retrieval.py packs
    # both into submission.json)
    idx_classes = {v: k for k, v in infer_ds.classes.items()}

    def _results_map(props: List[Dict]) -> Dict[str, List[Dict]]:
        res: Dict[str, List[Dict]] = {c: [] for c in seen_clips}
        for p in props:
            res.setdefault(p["video_id"], []).append({
                "label": idx_classes[p["label"]],
                "score": round(p["score"], 6),
                "segment": [round(p["t_start"], 1), round(p["t_end"], 1)],
            })
        return res

    det_map = _results_map(predictions)
    rev_map = _results_map(retrieval_preds)
    for name, results in (("detections_postNMS.json", det_map),
                          ("retreival_postNMS.json", rev_map)):
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"version": "1.0", "external_data": "",
                       "results": results}, f)
    with open(os.path.join(out_dir, "submission.json"), "w") as f:
        json.dump(mq_eval.pack_submission(det_map, rev_map), f)
    return metrics


def run_egonlq(
    train_meta: List[Dict],
    val_meta: List[Dict],
    feature_dir: str,
    ground_truth: Dict,
    epochs: int = 10,
    batch_size: int = 32,
    lr: float = 1e-3,
    max_pos_len: int = 256,
    video_feature_dim: int = 768,
    device="cuda",
    timings: Optional[Dict[str, List[float]]] = None,
) -> Dict[str, float]:
    """Train VSLNet on fused per-query features, official NLQ metrics."""
    from egovlpv2_torch.data.loader import DataLoader
    from egovlpv2_torch.downstream import nlq_eval, runners, vslnet
    from egovlpv2_torch.downstream.datasets import (NLQFeatureDataset,
                                                    nlq_highlight_labels)
    from egovlpv2_torch.train.step import batch_to_device

    device = _device(device)
    train_ds = NLQFeatureDataset(train_meta, feature_dir, max_pos_len)
    val_ds = NLQFeatureDataset(val_meta, feature_dir, max_pos_len)
    first = train_ds[0]
    if first["video_features"].shape[-1] != video_feature_dim:
        raise ValueError(f"video features of width "
                         f"{first['video_features'].shape[-1]} in "
                         f"{feature_dir}, not video_feature_dim "
                         f"{video_feature_dim}")
    # flax's Dense takes its input width from the data: the query tokens'
    model = vslnet.VSLNet(
        max_pos_len=max_pos_len, video_feature_dim=video_feature_dim,
        query_feature_dim=int(first["query_features"].shape[-1]),
        device=device)
    loader = DataLoader(train_ds, batch_size, drop_last=True)
    _, _, step, predict = runners.make_vslnet_train_step(
        model, lr=lr, num_train_steps=epochs * len(loader))
    runners.init_head_state(model)

    def collate_train(batch):
        q = batch["query_features"]
        return {
            "video_features": batch["video_features"],
            "v_mask": batch["v_mask"],
            "query_features": q,
            "q_mask": np.ones(q.shape[:2], np.int32),
            "s_ind": batch["s_ind"],
            "e_ind": batch["e_ind"],
            "h_labels": nlq_highlight_labels(
                np.asarray(batch["s_ind"]), np.asarray(batch["e_ind"]),
                batch["video_features"].shape[1]),
        }

    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            _timed(device, timings, "step", step,
                   collate_train(_arrays(batch, "meta")))

    predictions = []
    for i in range(len(val_ds)):
        item = val_ds[i]
        q = item["query_features"][None]
        t = batch_to_device({"video_features": item["video_features"][None],
                             "v_mask": item["v_mask"][None],
                             "query_features": q,
                             "q_mask": np.ones(q.shape[:2], np.int32)},
                            device)
        starts, ends = _timed(device, timings, "infer", predict,
                              t["video_features"], t["v_mask"],
                              t["query_features"], t["q_mask"])
        m = item["meta"]
        n = m["num_windows"]
        times = []
        for s, e in zip(starts[0].tolist(), ends[0].tolist()):
            ts, te = nlq_eval.index_to_time(min(int(s), n - 1),
                                            min(int(e), n - 1), n,
                                            m["duration"])
            times.append([float(ts), float(te)])
        predictions.append({
            "clip_uid": m["clip_uid"], "annotation_uid": m["annotation_uid"],
            "query_idx": m["query_idx"], "predicted_times": times,
        })
    results, miou = nlq_eval.evaluate_nlq(predictions, ground_truth)
    return {
        "R1@0.3": 100 * results[0][0], "R5@0.3": 100 * results[0][1],
        "R1@0.5": 100 * results[1][0], "R5@0.5": 100 * results[1][1],
        "mIoU": 100 * miou,
    }


def run_egotaskqa(
    backbone_cfg: ModelConfig,
    train_items,  # indexable of dicts with video/text_ids/text_mask/answer
    val_items,
    num_answers: int,
    reasoning_types: Sequence[str] = (),
    epochs: int = 1,
    batch_size: int = 8,
    lr: float = 2e-4,
    warmup_frac: float = 0.1,
    save_dir: Optional[str] = None,
    resume: bool = False,
    test_only: bool = False,
    backbone_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
    on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None,
) -> Dict[str, float]:
    """Fine-tune the fused backbone + QA head, report overall and
    per-reasoning-type accuracy (EgoTaskQA/main_end2end.py:84-200 recipe:
    single-LR AdamW + cosine warmup).

    `save_dir` checkpoints the run each epoch; `resume` restarts from the
    latest checkpoint (main_end2end.py:164-172: global_step -> epoch);
    `test_only` skips training and evaluates the restored checkpoint
    (main_end2end.py:174-200). `backbone_state_dict` (an `EgoVLPv2`
    state_dict, e.g. an imported pretrain checkpoint) is overlaid onto the
    backbone before training, the names the two share.

    On a CUDA device this sets TF32 off for matmuls and cuDNN: the float32
    path runs in full float32. `on_step(step, metrics, seconds)` is called
    after every training step with the host's time of the step, from its
    numpy batch to the end of its device work.
    """
    from egovlpv2_torch.data.loader import DataLoader, default_collate
    from egovlpv2_torch.downstream.taskqa import (evaluate_qa, make_qa_model,
                                                  make_qa_train_step)
    from egovlpv2_torch.train.checkpoint import (CheckpointManager,
                                                 load_train_state_,
                                                 train_state)
    from egovlpv2_torch.train.optimizer import make_adamw_warmup_cosine
    from egovlpv2_torch.weights import overlay_, training_init_

    if test_only and not save_dir:
        # without a checkpoint to restore, "evaluation" would silently score
        # randomly-initialized QA-head weights and report it as a result
        raise ValueError("test_only requires save_dir (the checkpoint "
                         "directory to evaluate)")
    device = _device(device)

    model = make_qa_model(backbone_cfg, num_answers, device=device)
    init = torch.Generator().manual_seed(0)
    training_init_(model.backbone, init)
    training_init_(model.qa_head, init)
    steps_per_epoch = max(len(train_items) // batch_size, 1)
    total_steps = max(epochs * steps_per_epoch, 1)
    optimizer, scheduler = make_adamw_warmup_cosine(
        model, lr, max(int(total_steps * warmup_frac), 1), total_steps)
    if backbone_state_dict is not None:
        # intersection overlay: the QA model holds only the fused-encode
        # path, while a pretrain checkpoint carries projection/MLM heads too
        overlay_(model.backbone, backbone_state_dict)
    generator = torch.Generator(device=device).manual_seed(1)

    ckpt = None
    start_epoch = 0
    step = 0
    if save_dir:
        ckpt = CheckpointManager(save_dir)
        if resume or test_only:
            restored = ckpt.restore()
            if restored is not None:
                step = load_train_state_(restored, model, optimizer,
                                         scheduler, generator)
                start_epoch = step // steps_per_epoch
            elif test_only:
                raise FileNotFoundError(
                    f"test_only: no checkpoint found under {save_dir}")

    if not test_only:
        train_step = make_qa_train_step(model, optimizer, scheduler,
                                        generator)
        loader = DataLoader(train_items, batch_size)
        for epoch in range(start_epoch, epochs):
            for batch in loader.epoch(epoch):
                t0 = time.perf_counter()
                metrics = train_step({k: v for k, v in batch.items()
                                      if k != "reasoning_types"})
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                seconds = time.perf_counter() - t0
                step += 1
                if on_step is not None:
                    on_step(step, {k: float(v) for k, v in metrics.items()},
                            seconds)
            if ckpt:
                ckpt.save(step, train_state(model, optimizer, scheduler,
                                            generator, step))
        if ckpt:
            ckpt.wait()

    val_batches = []
    for i in range(0, len(val_items) - batch_size + 1, batch_size):
        chunk = [val_items[j] for j in range(i, i + batch_size)]
        b = default_collate(chunk)
        b["reasoning_types"] = [it.get("reasoning_types", []) for it in chunk]
        val_batches.append(b)
    return evaluate_qa(model, val_batches, list(reasoning_types))


def run_qfvs(
    dataset,  # egovlpv2_torch.downstream.qfvs_data.QFVSDataset (train videos)
    test_items: List[Dict],  # same layout, held-out video's items
    shots_tag: np.ndarray,
    epochs: int = 5,
    lr: float = 1e-4,
    top_percent: float = 0.02,
    d_model: Optional[int] = None,
    device="cuda",
    timings: Optional[Dict[str, List[float]]] = None,
) -> Dict[str, float]:
    """Train the summary scorer, evaluate leave-one-out bipartite F1."""
    from egovlpv2_torch.downstream import qfvs, runners
    from egovlpv2_torch.train.step import batch_to_device

    device = _device(device)
    if d_model is None:  # follow the fused feature width (reference: 768)
        d_model = int(dataset[0]["feat_concept1"].shape[-1])
    model = qfvs.SummaryScorer(d_model=d_model, device=device)
    generator = runners.init_head_state(model)
    _, _, step, score = runners.make_qfvs_train_step(
        model, lr=lr, total_steps=epochs * len(dataset), generator=generator)
    keys = ("seg_len", "mask", "feat_concept1", "feat_concept2", "feat_oracle",
            "concept1_GT", "concept2_GT", "oracle_GT")
    for _ in range(epochs):
        for i in range(len(dataset)):
            item = dataset[i]
            _timed(device, timings, "step", step,
                   {k: np.asarray(item[k])[None] for k in keys})

    f1s = []
    for item in test_items:
        t = batch_to_device({"feat_oracle": item["feat_oracle"][None],
                             "seg_len": np.asarray(item["seg_len"])[None]},
                            device)
        logits = _timed(device, timings, "infer", score, t["feat_oracle"],
                        t["seg_len"])[0].cpu().numpy()
        mask = np.asarray(item["mask"]).astype(bool)
        machine = qfvs.top_percent_shots(logits, mask, top_percent)
        gt = np.nonzero(item["oracle_GT"].reshape(-1))[0]
        _, _, f1 = qfvs.semantic_matching_f1(machine, gt, shots_tag)
        f1s.append(f1)
    return {"F1": float(np.mean(f1s)) * 100}
