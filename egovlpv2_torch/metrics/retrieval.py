"""Retrieval / MCQ metrics (the port's own copy of
`egovlpv2_tpu/metrics/retrieval.py`; numpy, computed on the host after the
device's embeddings are gathered).

Capability-parity targets: `EgoVLPv2/model/metric.py` (t2v_metrics:26,
v2t_metrics:134, egomcq_accuracy_metrics:225-259, charades map:327-383),
`EgoVLPv2/utils/nDCG.py`, `EgoVLPv2/utils/mAP.py`. A test holds every
function here against its original on seeded inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _ranks_to_metrics(ranks: np.ndarray, num_queries: int) -> Dict[str, float]:
    metrics = {}
    metrics["R1"] = 100 * float(np.sum(ranks == 0)) / num_queries
    metrics["R5"] = 100 * float(np.sum(ranks < 5)) / num_queries
    metrics["R10"] = 100 * float(np.sum(ranks < 10)) / num_queries
    metrics["R50"] = 100 * float(np.sum(ranks < 50)) / num_queries
    metrics["MedR"] = float(np.median(ranks) + 1)
    metrics["MeanR"] = float(np.mean(ranks) + 1)
    metrics["geometric_mean_R1-R5-R10"] = float(
        np.exp(np.mean(np.log(np.maximum(
            [metrics["R1"], metrics["R5"], metrics["R10"]], 1e-12))))
    )
    return metrics


def t2v_metrics(sims: np.ndarray, query_masks: Optional[np.ndarray] = None):
    """Text->video R@k/MedR with optimistic tie-breaking (metric.py:26-131).

    sims[i, j] = <text_i, video_j>; queries_per_video = N // M rows map to
    video j = i // qpv.
    """
    sims = np.asarray(sims)
    num_queries, num_vids = sims.shape
    dists = -sims
    qpv = num_queries // num_vids
    sorted_dists = np.sort(dists, axis=1)
    gt_dists = np.stack(
        [dists[i, i // qpv] for i in range(num_queries)]
    )[:, None]
    rows, cols = np.where((sorted_dists - gt_dists) == 0)
    if rows.size > num_queries:  # ties: break optimistically (first match)
        _, idx = np.unique(rows, return_index=True)
        cols = cols[idx]
    if query_masks is not None:
        cols = cols[query_masks.reshape(-1).astype(bool)]
        num_queries = int(query_masks.sum())
    return _ranks_to_metrics(cols, num_queries)


def v2t_metrics(sims: np.ndarray, query_masks: Optional[np.ndarray] = None):
    """Video->text: rank of the best caption per video, tie-averaged
    (metric.py:134-223)."""
    sims = np.asarray(sims).T
    num_queries, num_caps = sims.shape
    dists = -sims
    cpv = num_caps // num_queries
    ranks = []
    for i in range(num_queries):
        row = dists[i]
        if query_masks is not None:
            row = row.copy()
            row[np.logical_not(query_masks.reshape(-1))] = 1e8
        srt = np.sort(row)
        best = np.inf
        for j in range(i * cpv, (i + 1) * cpv):
            if row[j] == 1e8:
                continue
            r = np.where((srt - row[j]) == 0)[0].mean()
            best = min(best, r)
        ranks.append(best)
    return _ranks_to_metrics(np.array(ranks), num_queries)


def egomcq_accuracy(preds: np.ndarray, labels: np.ndarray, types: np.ndarray):
    """5-way MCQ accuracy split Inter-/Intra-video (metric.py:225-241).

    types: 1 = inter-video, 2 = intra-video (EgoMCQ json convention)."""
    metrics = {}
    for type_i, group in zip(sorted(np.unique(types).tolist()),
                             ["Inter-video", "Intra-video"]):
        sel = types == type_i
        correct = np.argmax(preds[sel], axis=1) == labels[sel]
        metrics[group] = 100.0 * float(np.mean(correct))
    return metrics


# ---------------- EK-100 MIR official nDCG / mAP ----------------


def calculate_k_counts(relevancy: np.ndarray) -> np.ndarray:
    return (np.sort(relevancy)[:, ::-1] > 0).astype(int)


def calculate_DCG(sim: np.ndarray, relevancy: np.ndarray, k_counts: np.ndarray):
    x_sz, y_sz = sim.shape
    ranks = np.argsort(sim)[:, ::-1]
    logs = np.log2(np.arange(y_sz) + 2)
    columns = np.arange(x_sz)[:, None]
    numerators = relevancy[columns, ranks] * k_counts
    return np.sum(numerators / logs[None, :], axis=1)


def calculate_IDCG(relevancy: np.ndarray, k_counts: np.ndarray):
    return calculate_DCG(relevancy, relevancy, k_counts)


def calculate_nDCG(sim, relevancy, k_counts=None, IDCG=None, reduction="mean"):
    if k_counts is None:
        k_counts = calculate_k_counts(relevancy)
    DCG = calculate_DCG(sim, relevancy, k_counts)
    if IDCG is None:
        IDCG = calculate_IDCG(relevancy, k_counts)
    out = DCG / IDCG
    return float(np.mean(out)) if reduction == "mean" else out


def calculate_mAP(sim: np.ndarray, relevancy: np.ndarray) -> float:
    """Official EK-100 retrieval mAP (utils/mAP.py:10-49)."""
    order = (-sim).argsort()
    rows = np.arange(sim.shape[0])[:, None]
    ranked_rel = relevancy[rows, order]
    cum = np.cumsum(ranked_rel, axis=1)
    cum = np.where(ranked_rel == 1, cum, 0.0)
    divisor = np.arange(ranked_rel.shape[1]) + 1
    n_rel = np.sum(ranked_rel == 1, axis=1)
    ap = np.sum(cum / divisor, axis=1) / n_rel
    return float(np.mean(ap))


def mir_metrics(sim: np.ndarray, relevancy: np.ndarray) -> Dict[str, float]:
    """EK-100 MIR: nDCG + mAP both directions (metric.py:283-325).

    `sim` must already be video x text ordered to match `relevancy`
    ((sim+1)/2 rescaling applied here as in the reference)."""
    sim = (sim + 1) / 2
    k_v = calculate_k_counts(relevancy)
    k_t = calculate_k_counts(relevancy.T)
    idcg_v = calculate_IDCG(relevancy, k_v)
    idcg_t = calculate_IDCG(relevancy.T, k_t)
    vis_ndcg = calculate_nDCG(sim, relevancy, k_v, IDCG=idcg_v)
    txt_ndcg = calculate_nDCG(sim.T, relevancy.T, k_t, IDCG=idcg_t)
    vis_map = calculate_mAP(sim, relevancy)
    txt_map = calculate_mAP(sim.T, relevancy.T)
    return {
        "nDCG_V2T": vis_ndcg * 100,
        "nDCG_T2V": txt_ndcg * 100,
        "nDCG_AVG": 50 * (vis_ndcg + txt_ndcg),
        "mAP_V2T": vis_map * 100,
        "mAP_T2V": txt_map * 100,
        "mAP_AVG": 50 * (vis_map + txt_map),
    }


def oscc_accuracy(preds: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Object-state-change classification accuracy (metric.py:386-397)."""
    return {"accuracy": 100.0 * float(np.mean(np.argmax(preds, -1) == labels))}


def pnr_distance(preds: np.ndarray, labels: np.ndarray,
                 fps: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Point-of-no-return temporal localization error in seconds
    (metric.py:399+): |argmax(pred) - label| / fps averaged."""
    err = np.abs(np.argmax(preds, -1) - labels).astype(np.float64)
    if fps is not None:
        err = err / fps
    return {"distance": float(np.mean(err))}


# ---------------- Charades-Ego ----------------


def per_class_ap(submission: np.ndarray, gt: np.ndarray):
    """Per-class AP over ranked examples (metric.py:327-352)."""
    m_aps = []
    for c in range(submission.shape[1]):
        idx = np.argsort(-submission[:, c])
        tp = gt[idx, c] == 1
        n_pos = tp.sum()
        if n_pos < 0.1:
            m_aps.append(np.nan)
            continue
        fp = ~tp
        prec = np.cumsum(tp) / (np.cumsum(fp) + np.cumsum(tp)).astype(float)
        m_aps.append(prec[tp].sum() / float(n_pos))
    m_aps = np.array(m_aps)
    m_ap = np.nanmean(m_aps)
    w_ap = m_aps * gt.sum(axis=0) / float(gt.sum())
    return m_ap, w_ap, m_aps


def charades_map(submission: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Charades mAP; rows with no positive labels are excluded by -inf
    (metric.py:354-367)."""
    fix = submission.copy().astype(float)
    fix[gt.sum(axis=1) == 0, :] = -np.inf
    m_ap, _, _ = per_class_ap(fix, gt)
    return {"mAP": float(m_ap)}
