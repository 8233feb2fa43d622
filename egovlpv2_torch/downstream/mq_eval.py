"""EgoMQ detection evaluation: ANETdetection-style mAP@tIoU (numpy; a copy
of `egovlpv2_tpu/downstream/mq_eval.py`).

Capability-parity target: `EgoMQ/Evaluation/ego4d/eval_detection.py`
(compute_average_precision_detection:221, interpolated 11-free PR AUC) and
`get_detect_performance.py:10-30` (per-class AP averaged over tIoU
thresholds). Pure-python dicts replace the pandas dataframes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """target [2], candidates [N, 2] -> IoU [N] (set union, ANET semantics)."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(tt2 - tt1, 0, None)
    union = (
        (candidates[:, 1] - candidates[:, 0])
        + (target[1] - target[0])
        - inter
    )
    return inter / np.maximum(union, 1e-12)


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """AUC of the interpolated precision-recall curve (Pascal VOC style)."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_detection(
    ground_truth: List[Dict],
    prediction: List[Dict],
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
) -> np.ndarray:
    """AP per tIoU threshold for one class.

    ground_truth / prediction: dicts with video_id, t_start, t_end (+ score
    for predictions). Greedy highest-IoU matching with per-gt locks
    (eval_detection.py:243-301)."""
    tiou_thresholds = np.asarray(tiou_thresholds, np.float64)
    ap = np.zeros(len(tiou_thresholds))
    if not prediction:
        return ap
    npos = float(len(ground_truth))
    if npos == 0:
        return ap

    gt_by_video: Dict[str, List[int]] = {}
    for gi, g in enumerate(ground_truth):
        gt_by_video.setdefault(g["video_id"], []).append(gi)
    gt_spans = np.array([[g["t_start"], g["t_end"]] for g in ground_truth])

    order = np.argsort([-p["score"] for p in prediction])
    lock = -np.ones((len(tiou_thresholds), len(ground_truth)))
    tp = np.zeros((len(tiou_thresholds), len(prediction)))
    fp = np.zeros((len(tiou_thresholds), len(prediction)))

    for rank, pi in enumerate(order):
        p = prediction[pi]
        gts = gt_by_video.get(p["video_id"])
        if not gts:
            fp[:, rank] = 1
            continue
        spans = gt_spans[gts]
        tiou = segment_iou(np.array([p["t_start"], p["t_end"]]), spans)
        by_iou = np.argsort(-tiou)
        for ti, thr in enumerate(tiou_thresholds):
            assigned = False
            for j in by_iou:
                if tiou[j] < thr:
                    fp[ti, rank] = 1
                    assigned = True
                    break
                if lock[ti, gts[j]] >= 0:
                    continue
                tp[ti, rank] = 1
                lock[ti, gts[j]] = rank
                assigned = True
                break
            if not assigned:
                fp[ti, rank] = 1

    tp_c = np.cumsum(tp, axis=1)
    fp_c = np.cumsum(fp, axis=1)
    recall = tp_c / npos
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    for ti in range(len(tiou_thresholds)):
        ap[ti] = interpolated_prec_rec(precision[ti], recall[ti])
    return ap


def span_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU [P, G] with SPAN union (max(e)-min(s), not set union).

    This is the retrieval metric's overlap definition
    (`EgoMQ/Evaluation/ego4d/get_retrieval_performance.py:130-148`), which
    differs from `segment_iou`'s detection semantics."""
    pred = np.asarray(pred, np.float64).reshape(-1, 2)
    gt = np.asarray(gt, np.float64).reshape(-1, 2)
    inter_l = np.maximum(pred[:, 0, None], gt[None, :, 0])
    inter_r = np.minimum(pred[:, 1, None], gt[None, :, 1])
    inter = np.maximum(0.0, inter_r - inter_l)
    union_l = np.minimum(pred[:, 0, None], gt[None, :, 0])
    union_r = np.maximum(pred[:, 1, None], gt[None, :, 1])
    union = np.maximum(0.0, union_r - union_l)
    return inter / np.maximum(union, 1e-12)


def retrieval_recall(
    ground_truth: List[Dict],
    prediction: List[Dict],
    tious: Sequence[float] = (0.3, 0.5, 0.7),
    recalls: Sequence[int] = (1, 2, 3, 4, 5),
) -> Dict[str, float]:
    """Moment-retrieval Recall rx @ tIoU over per-(clip, label) ranked lists.

    Capability-parity target: `get_retrieval_performance.py:93-127`
    (Moment_Retrieval.evaluate): for each clip and each GT label, rank that
    label's predictions by score; a GT instance counts as retrieved at rank
    budget r if any of the top r*num_gt predictions overlaps it with
    span-IoU > t. Labels with no predictions contribute misses. Entries use
    the same dict format as `detection_map` (video_id/t_start/t_end/label,
    predictions add score)."""
    gt_groups: Dict[tuple, List[List[float]]] = {}
    for g in ground_truth:
        gt_groups.setdefault((g["video_id"], g["label"]), []).append(
            [g["t_start"], g["t_end"]])
    pred_groups: Dict[tuple, List[List[float]]] = {}
    for p in prediction:
        pred_groups.setdefault((p["video_id"], p["label"]), []).append(
            [p["t_start"], p["t_end"], p["score"]])

    hits = np.zeros((len(tious), len(recalls)))
    total = 0
    for key, gts in gt_groups.items():
        num_gt = len(gts)
        total += num_gt
        preds = pred_groups.get(key)
        if not preds:
            continue
        preds = sorted(preds, key=lambda r: -r[2])
        overlap = span_iou(np.array(preds)[:, :2], np.array(gts))  # [P, G]
        for i, t in enumerate(tious):
            above = overlap > t
            for j, r in enumerate(recalls):
                hits[i, j] += above[: r * num_gt].any(axis=0).sum()

    out = {}
    for i, t in enumerate(tious):
        for j, r in enumerate(recalls):
            out[f"recall@{r}x_tiou{t:g}"] = (
                float(hits[i, j] / total) if total else 0.0)
    return out


def pack_submission(detections: List[Dict], retrievals: List[Dict],
                    version: str = "1.0") -> Dict:
    """Challenge submission dict (`EgoMQ/Merge_detection_retrieval.py:40-45`).

    Both inputs are {clip_id: [{label, score, segment}]} results maps."""
    return {
        "version": version,
        "challenge": "ego4d_moment_queries",
        "detect_results": detections,
        "retrieve_results": retrievals,
    }


def detection_map(
    ground_truth: List[Dict],
    prediction: List[Dict],
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
) -> Dict[str, float]:
    """Per-class AP -> mAP per threshold + average (get_detect_performance.py).

    Entries carry a `label` field; classes are evaluated independently."""
    labels = sorted({g["label"] for g in ground_truth})
    aps = np.zeros((len(labels), len(tiou_thresholds)))
    for li, label in enumerate(labels):
        gt_l = [g for g in ground_truth if g["label"] == label]
        pred_l = [p for p in prediction if p["label"] == label]
        aps[li] = average_precision_detection(gt_l, pred_l, tiou_thresholds)
    m_ap = aps.mean(axis=0)
    out = {f"mAP@{t:g}": float(v) for t, v in zip(tiou_thresholds, m_ap)}
    out["mAP_avg"] = float(m_ap.mean())
    return out
