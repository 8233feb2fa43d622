"""QFVS: KTS kernel segmentation, summary scorer, bipartite-matching F1
(port of `egovlpv2_tpu/downstream/qfvs.py`).

Capability-parity targets:
  * `QFVS/segment/cpd_auto.py` + `cpd_nonlin.py` — kernel temporal
    segmentation (KTS): dynamic programming over kernelized scatters with
    automatic selection of the change-point count. The reference's O(n^2)
    python loops are vectorized with numpy, as in the JAX package;
  * `QFVS/model/model_summary.py` — 2-layer transformer encoder (d=768,
    nhead=2, post-LN torch TransformerEncoderLayer semantics) + sinusoidal
    positions + projector(768->8) + summ_head(8->1) over per-shot features;
  * `QFVS/runner_train.py:111-175` — per-sample masked BCEWithLogits over
    concept1/concept2/oracle scores;
  * `QFVS/semantic_evaluation.py:37-78` — shot-tag IoU weights + max-weight
    bipartite matching -> P/R/F1 (scipy linear_sum_assignment replaces
    networkx).

The scorer is float32. Its LayerNorms are flax's defaults (eps 1e-6, the
fast variance) through `ops.layernorm.LayerNorm`, so on a CUDA tensor they
run the hand-written K7 forward and K8 backward; its attention is plain
PyTorch with the JAX head's `where(mask, -1e9)` on padded keys. Dropout
draws from the generator given to `set_generator`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.dropout import Dropout
from egovlpv2_torch.ops.layernorm import LayerNorm


def calc_scatters(K: np.ndarray) -> np.ndarray:
    """Kernelized scatter of every segment [i, j] (cpd_nonlin.py:10-22),
    vectorized: scatters[i,j] = sum(diag K[i..j]) - blocksum(i..j)/(j-i+1)."""
    n = K.shape[0]
    K1 = np.concatenate([[0], np.cumsum(np.diag(K))])
    K2 = np.zeros((n + 1, n + 1))
    K2[1:, 1:] = np.cumsum(np.cumsum(K, 0), 1)
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    diag_sum = K1[j + 1] - K1[i]
    block = K2[j + 1, j + 1] + K2[i, i] - K2[j + 1, i] - K2[i, j + 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        scat = diag_sum - block / (j - i + 1)
    return np.where(j >= i, scat, 0.0)


def cpd_nonlin(K: np.ndarray, ncp: int, lmin: int = 1, lmax: int = 100000,
               backtrack: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """DP change-point detection (cpd_nonlin.py:24-96), inner loop vectorized."""
    m = int(ncp)
    n = K.shape[0]
    assert n >= (m + 1) * lmin and n <= (m + 1) * lmax
    J = calc_scatters(K)
    I = 1e101 * np.ones((m + 1, n + 1))
    I[0, lmin:lmax] = J[0, lmin - 1:lmax - 1]
    p = np.zeros((m + 1, n + 1), dtype=int)

    for k in range(1, m + 1):
        for l in range((k + 1) * lmin, n + 1):
            lo = max(k * lmin, l - lmax)
            hi = l - lmin + 1
            c = I[k - 1, lo:hi] + J[lo:hi, l - 1]
            t = int(np.argmin(c))
            I[k, l] = c[t]
            p[k, l] = lo + t

    cps = np.zeros(m, dtype=int)
    if backtrack:
        cur = n
        for k in range(m, 0, -1):
            cps[k - 1] = p[k, cur]
            cur = cps[k - 1]
    scores = I[:, n].copy()
    scores[scores > 1e99] = np.inf
    return cps, scores


def cpd_auto(K: np.ndarray, ncp: int, vmax: float, desc_rate: int = 1, **kw):
    """Auto change-point count via penalized cost (cpd_auto.py:11-54)."""
    m = ncp
    _, scores = cpd_nonlin(K, m, backtrack=False, **kw)
    n = K.shape[0]
    n2 = n * desc_rate
    penalties = np.zeros(m + 1)
    ks = np.arange(1, m + 1)
    penalties[1:] = (vmax * ks / (2.0 * n2)) * (np.log(float(n2) / ks) + 1)
    costs = scores / float(n) + penalties
    m_best = int(np.argmin(costs))
    cps, _ = cpd_nonlin(K, m_best, **kw)
    return cps, costs


# ---------------- summary scorer ----------------


def sinusoid_positions(seq_len: int, dim: int) -> np.ndarray:
    pos = np.arange(seq_len)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000, (2 * (i // 2)) / dim)
    pe = np.zeros((seq_len, dim))
    pe[:, 0::2] = np.sin(angle[:, 0::2])
    pe[:, 1::2] = np.cos(angle[:, 1::2])
    return pe.astype(np.float32)


class TorchStyleEncoderLayer(nn.Module):
    """Post-LN nn.TransformerEncoderLayer equivalent (d_model, nhead,
    dim_feedforward=2048, relu)."""

    def __init__(self, d_model: int, nhead: int, dim_ff: int = 2048,
                 drop: float = 0.1, device=None):
        super().__init__()
        self.nhead = nhead
        for name in ("q", "k", "v", "out"):
            setattr(self, name, Dense(d_model, d_model, device=device))
        self.ff1 = Dense(d_model, dim_ff, device=device)
        self.ff2 = Dense(dim_ff, d_model, device=device)
        self.norm1 = LayerNorm(d_model, eps=1e-6, device=device)
        self.norm2 = LayerNorm(d_model, eps=1e-6, device=device)
        self.dropout = Dropout(drop)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, s, d = x.shape
        h = self.nhead
        dh = d // h

        def heads(t):
            return t.reshape(b, s, h, dh).transpose(1, 2)

        logits = heads(self.q(x)) @ heads(self.k(x)).transpose(-1, -2) \
            / math.sqrt(dh)
        if key_padding_mask is not None:  # True = masked out
            logits = torch.where(key_padding_mask[:, None, None, :],
                                 torch.full_like(logits, -1e9), logits)
        att = torch.softmax(logits, dim=-1) @ heads(self.v(x))
        att = self.out(att.transpose(1, 2).reshape(b, s, d))
        x = self.norm1(x + self.dropout(att))
        ff = self.ff2(self.dropout(torch.relu(self.ff1(x))))
        return self.norm2(x + self.dropout(ff))


class SummaryScorer(nn.Module):
    """Per-shot summary scores (model_summary.py:35-80).

    Input: [B, max_segments, max_shots, D] fused shot features + seg_len
    [B, max_segments]; output [B, max_segments, max_shots] logits.
    """

    def __init__(self, d_model: int = 768, nhead: int = 2, num_layers: int = 2,
                 device=None):
        super().__init__()
        self.d_model = d_model
        self.layer = nn.ModuleList([
            TorchStyleEncoderLayer(d_model, nhead, device=device)
            for _ in range(num_layers)])
        self.projector = nn.ModuleDict({"1": Dense(d_model, 8, device=device)})
        self.summ_head = Dense(8, 1, device=device)
        self.dropout = Dropout(0.2)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout mask in training mode comes from `generator`."""
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = generator

    def forward(self, feats: torch.Tensor, seg_len: torch.Tensor
                ) -> torch.Tensor:
        b, n_seg, n_shot, d = feats.shape
        pe = torch.from_numpy(sinusoid_positions(n_shot, self.d_model))
        x = feats.reshape(b * n_seg, n_shot, d) + pe.to(feats.device)
        pad = torch.arange(n_shot, device=feats.device)[None, :] \
            >= seg_len.reshape(-1)[:, None]
        for layer in self.layer:
            x = layer(x, key_padding_mask=pad)
        x = self.dropout(torch.relu(self.projector["1"](x)))
        return self.summ_head(x)[..., 0].reshape(b, n_seg, n_shot)


def qfvs_bce_loss(logits, targets, mask):
    """Masked BCEWithLogits summed over samples (runner_train.py:147-166)."""
    logits, targets, mask = logits.float(), targets.float(), mask.float()
    per = torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    per_sample = torch.sum(per * mask, dim=(1, 2)) / torch.clamp(
        torch.sum(mask, dim=(1, 2)), min=1.0)
    return torch.sum(per_sample)


# ---------------- semantic evaluation ----------------


def semantic_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of binary concept-tag vectors."""
    inter = a @ b.T
    union = (a[:, None, :] + b[None, :, :] > 0).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out


def semantic_matching_f1(
    machine_shots: Sequence[int],
    gt_shots: Sequence[int],
    shots_tag: np.ndarray,
) -> Tuple[float, float, float]:
    """Max-weight bipartite matching F1 (semantic_evaluation.py:60-78);
    scipy's linear_sum_assignment replaces networkx."""
    from scipy.optimize import linear_sum_assignment

    m = shots_tag[np.asarray(machine_shots, int)]
    g = shots_tag[np.asarray(gt_shots, int)]
    w = semantic_iou_matrix(m.astype(np.float64), g.astype(np.float64))
    rows, cols = linear_sum_assignment(-w)
    total = w[rows, cols].sum()
    precision = total / m.shape[0]
    recall = total / g.shape[0]
    f1 = 0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall)
    return float(precision), float(recall), float(f1)


def top_percent_shots(scores: np.ndarray, mask: np.ndarray, top_percent: float):
    """Select the top-p% shots by score over valid positions (the reference
    selects top 2% for the final summary, runner_train.py:207-226)."""
    flat_scores = scores[mask.astype(bool)]
    n_total = int(mask.sum())
    k = max(int(round(n_total * top_percent)), 1)
    order = np.argsort(-flat_scores)
    # map back to (segment, shot) -> global shot index = cumulative position
    sel = np.zeros(n_total, dtype=bool)
    sel[order[:k]] = True
    return np.nonzero(sel)[0]
