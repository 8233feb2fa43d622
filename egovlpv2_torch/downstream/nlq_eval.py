"""Official Ego4D NLQ evaluation (numpy; a copy of
`egovlpv2_tpu/downstream/nlq_eval.py`).

Capability-parity target: `EgoNLQ/utils/evaluate_ego4d_nlq.py:43-122`
(compute_IoU, evaluate_nlq_performance): R@{topK} at IoU thresholds plus
mIoU over the mean of the top-3 overlaps per query.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred [P, 2], gt [G, 2] -> IoU [P, G] with union = hull (reference
    semantics: union taken as min(left)..max(right))."""
    pred = np.atleast_2d(np.asarray(pred, np.float64))
    gt = np.atleast_2d(np.asarray(gt, np.float64))
    inter_l = np.maximum(pred[:, 0, None], gt[None, :, 0])
    inter_r = np.minimum(pred[:, 1, None], gt[None, :, 1])
    inter = np.maximum(0.0, inter_r - inter_l)
    union_l = np.minimum(pred[:, 0, None], gt[None, :, 0])
    union_r = np.maximum(pred[:, 1, None], gt[None, :, 1])
    union = np.maximum(0.0, union_r - union_l)
    return inter / np.maximum(union, 1e-12)


def evaluate_nlq(
    predictions: Sequence[Dict],
    ground_truth: Dict[Tuple[str, str, int], Tuple[float, float]],
    thresholds: Sequence[float] = (0.3, 0.5),
    top_k: Sequence[int] = (1, 5),
) -> Tuple[np.ndarray, float]:
    """predictions: dicts with clip_uid / annotation_uid / query_idx /
    predicted_times [[s, e], ...] ranked. ground_truth keyed by
    (clip_uid, annotation_uid, query_idx) -> (start_sec, end_sec).

    Returns (results[threshold][k] in percent-friendly fractions, mIoU)."""
    results = [[[] for _ in top_k] for _ in thresholds]
    average_iou = []
    for pred in predictions:
        key = (pred["clip_uid"], pred["annotation_uid"], pred["query_idx"])
        gt_span = ground_truth[key]
        overlap = compute_iou(np.asarray(pred["predicted_times"]),
                              np.asarray([gt_span]))
        average_iou.append(np.mean(np.sort(overlap[:, 0])[-3:]))
        for ti, th in enumerate(thresholds):
            for ki, k in enumerate(top_k):
                results[ti][ki].append(bool((overlap[:k, 0] > th).any()))
    mean_results = np.array(results, dtype=np.float64).mean(axis=-1)
    return mean_results, float(np.mean(average_iou))


def index_to_time(start_idx, end_idx, num_units, duration):
    """Feature index -> seconds (EgoNLQ/utils/data_util.py:133 semantics)."""
    s_times = np.arange(0, num_units).astype(np.float64) * duration / float(num_units)
    e_times = np.arange(1, num_units + 1).astype(np.float64) * duration / float(num_units)
    return s_times[start_idx], e_times[end_idx]


def time_to_index(start_time, end_time, num_units, duration):
    """Seconds -> best-matching feature span (EgoNLQ/utils/data_util.py:113)."""
    s_times = np.arange(0, num_units).astype(np.float64) * duration / float(num_units)
    e_times = np.arange(1, num_units + 1).astype(np.float64) * duration / float(num_units)
    candidates = np.stack(
        [np.repeat(s_times[:, None], num_units, 1),
         np.repeat(e_times[None, :], num_units, 0)], axis=2
    ).reshape(-1, 2)
    overlaps = compute_iou(candidates, np.asarray([[start_time, end_time]]))[:, 0]
    idx = np.argmax(overlaps)
    return idx // num_units, idx % num_units, overlaps.reshape(num_units, num_units)
