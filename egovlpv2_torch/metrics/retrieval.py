"""EgoMCQ accuracy (the port's own copy of `egomcq_accuracy` in
`egovlpv2_tpu/metrics/retrieval.py`; numpy, computed on the host). The
retrieval, nDCG and mAP metrics of that module come with the fine-tune
tasks."""

from __future__ import annotations

from typing import Dict

import numpy as np


def egomcq_accuracy(preds: np.ndarray, labels: np.ndarray,
                    types: np.ndarray) -> Dict[str, float]:
    """5-way MCQ accuracy split Inter-/Intra-video (metric.py:225-241).

    types: 1 = inter-video, 2 = intra-video (EgoMCQ json convention)."""
    metrics = {}
    for type_i, group in zip(sorted(np.unique(types).tolist()),
                             ["Inter-video", "Intra-video"]):
        sel = types == type_i
        correct = np.argmax(preds[sel], axis=1) == labels[sel]
        metrics[group] = 100.0 * float(np.mean(correct))
    return metrics
