"""ITM hard-negative mining over the whole batch (port of
`egovlpv2_tpu/objectives/itm_mining.py`; reference
`EgoVLPv2/model/model.py:426-483`).

Per example, a fair coin picks the direction, a categorical draw over the
softmaxed similarity row (with the EgoNCE positives masked out) picks the
hard negative, and positives keep their own pair. Half the batch
(floor(B/2)) is positive, shuffled. The draws come from a
`torch.Generator`, so they are not those of `jax.random` for the same
seed; the parts without randomness (`mining_weights`, `combine_indices`)
are separate functions so that tests hold them against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ITMIndices(NamedTuple):
    video_idx: torch.Tensor  # [B] which example's video to use
    text_idx: torch.Tensor  # [B] which example's text to use
    labels: torch.Tensor  # [B] 1 = matching pair, 0 = mined negative


def mining_weights(sim: torch.Tensor, mask_bool: torch.Tensor,
                   temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_t2v, w_v2t), each [B, B]: the rows from which a text's negative
    video and a video's negative text are drawn; positives weigh 0."""
    sim = sim.detach().float()
    w_v2t = torch.softmax(sim / temperature, dim=1)
    w_t2v = torch.softmax(sim.T / temperature, dim=1)
    zero = torch.zeros_like(w_v2t)
    return (torch.where(mask_bool, zero, w_t2v),
            torch.where(mask_bool, zero, w_v2t))


def combine_indices(labels: torch.Tensor, coin: torch.Tensor,
                    neg_video: torch.Tensor,
                    neg_text: torch.Tensor) -> ITMIndices:
    """Positives keep their own pair; a negative swaps in the mined video
    (coin true) or the mined text (coin false)."""
    own = torch.arange(labels.shape[0], device=labels.device)
    is_pos = labels == 1
    video_idx = torch.where(is_pos, own, torch.where(coin, neg_video, own))
    text_idx = torch.where(is_pos, own, torch.where(coin, own, neg_text))
    return ITMIndices(video_idx, text_idx, labels)


def mine_itm_indices(generator: Optional[torch.Generator], sim: torch.Tensor,
                     mask_bool: torch.Tensor, temperature: float) -> ITMIndices:
    """sim [B, B] (rows = text, cols = video), mask_bool [B, B] the EgoNCE
    positive mask. `generator` lives on sim's device (None: the global one)."""
    b, dev = sim.shape[0], sim.device
    pos_len = b // 2
    labels = torch.cat([torch.ones(pos_len, dtype=torch.long, device=dev),
                        torch.zeros(b - pos_len, dtype=torch.long, device=dev)])
    labels = labels[torch.randperm(b, generator=generator, device=dev)]
    w_t2v, w_v2t = mining_weights(sim, mask_bool, temperature)
    # multinomial(w + 1e-9), as model.py:460,465
    neg_video = torch.multinomial(w_t2v + 1e-9, 1, generator=generator)[:, 0]
    neg_text = torch.multinomial(w_v2t + 1e-9, 1, generator=generator)[:, 0]
    coin = torch.rand(b, generator=generator, device=dev) < 0.5
    return combine_indices(labels, coin, neg_video, neg_text)
