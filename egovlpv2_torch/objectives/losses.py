"""Contrastive / matching / masked-LM objectives (port of
`egovlpv2_tpu/objectives/losses.py`; reference `EgoVLPv2/model/loss.py`
plus the CE reductions in `model/model.py:404-485`). Functions of whole
batches; autograd differentiates them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn import functional as F


def egonce_loss(sim: torch.Tensor, sim_v: torch.Tensor, sim_n: torch.Tensor,
                temperature: float = 0.05, noun: bool = True,
                verb: bool = True) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """EgoNCE (loss.py:33-61): scene-aware positives.

    sim: [B, B] cosine similarity (rows = text, cols = video). sim_v /
    sim_n: [B, B] verb / noun multi-hot cosine similarities; a pair is an
    extra positive iff it shares a verb AND a noun.

    Returns (loss, mask_bool [B, B], temperature); mask_bool is reused by
    the ITM hard-negative mining."""
    b = sim.shape[0]
    eye = torch.eye(b, dtype=sim.dtype, device=sim.device)
    if noun and verb:
        mask = sim_v * sim_n + eye
    elif noun:
        mask = sim_n + eye
    elif verb:
        mask = sim_v + eye
    else:
        mask = eye
    mask_bool = mask > 0

    i_sm = torch.softmax(sim / temperature, dim=1)
    j_sm = torch.softmax(sim.T / temperature, dim=1)
    loss_i = torch.log((i_sm * mask_bool).sum(dim=1)).mean()
    loss_j = torch.log((j_sm * mask_bool.T).sum(dim=1)).mean()
    return -loss_i - loss_j, mask_bool, temperature


def norm_softmax_loss(sim: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over the diagonal (loss.py:13-31)."""
    i_lsm = torch.log_softmax(sim / temperature, dim=1)
    j_lsm = torch.log_softmax(sim.T / temperature, dim=1)
    return -torch.diag(i_lsm).mean() - torch.diag(j_lsm).mean()


def max_margin_loss(sim: torch.Tensor, margin: float = 0.2,
                    weight: Optional[torch.Tensor] = None,
                    fix_norm: bool = True) -> torch.Tensor:
    """(Adaptive)MaxMarginRankingLoss (loss.py:65-143).

    With `weight` (per-row relevancy weights) this is the adaptive variant:
    hinge on w*margin - (pos - neg) over both directions, excluding the
    diagonal when fix_norm."""
    n = sim.shape[0]
    d = torch.diag(sim)[:, None]  # positives, broadcast over columns
    w = sim.new_ones((n,)) if weight is None else weight
    w = w[:, None]
    h1 = torch.relu(w * margin - (d - sim))
    h2 = torch.relu(w * margin - (d - sim.T))
    if fix_norm:
        off = 1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device)
        total = (h1 * off).sum() + (h2 * off).sum()
        count = 2.0 * n * (n - 1)
    else:
        total = h1.sum() + h2.sum()
        count = 2.0 * n * n
    return total / count


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label != -100 (model.py:414-418)."""
    total, count = masked_lm_sums(logits, labels)
    return total / torch.clamp(count, min=1)


def masked_lm_sums(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the CE summed over positions with label != -100, their count): the
    parts of `masked_lm_loss` that sum over the ranks of a process group."""
    vocab = logits.shape[-1]
    logits = logits.reshape(-1, vocab).float()
    labels = labels.reshape(-1).long()
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, safe[:, None])[:, 0]
    ce = (lse - tgt) * valid
    return ce.sum(), valid.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain CE for classification heads (loss.py:145-151)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


def itm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE over 2-way match logits (model.py:478)."""
    return cross_entropy_loss(logits, labels)
