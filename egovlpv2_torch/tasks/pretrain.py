"""Pre-training task assembly: model + optimizer + step + synthetic
batches (port of `egovlpv2_tpu/tasks/pretrain.py`).

The synthetic batch mirrors the EgoClip batch layout
(`trainer/trainer_egoclip.py:106-141`): video [B, F, H, W, C], tokenized
text (max_len 15), MLM-masked ids and labels, and the 582-dim noun /
118-dim verb multi-hot vectors. It is numpy only and makes the same draws
from the same `Generator` as the JAX package's (a test holds them equal).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from egovlpv2_torch.core.config import (FusionConfig, ModelConfig,
                                        OptimConfig, TextEncoderConfig,
                                        TrainConfig, VideoEncoderConfig)
from egovlpv2_torch.data.mlm import mask_tokens
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.parallel.mesh import train_generators
from egovlpv2_torch.train.optimizer import make_optimizer
from egovlpv2_torch.train.step import make_train_step
from egovlpv2_torch.weights import training_init_

NOUN_DIM = 582
VERB_DIM = 118


def synthetic_batch(cfg: TrainConfig, batch_size: int,
                    rng: Optional[np.random.Generator] = None,
                    dtype=np.float32) -> Dict[str, np.ndarray]:
    rng = rng or np.random.default_rng(0)
    v = cfg.model.video
    video = rng.standard_normal(
        (batch_size, v.num_frames, v.img_size, v.img_size, v.in_chans),
        np.float32).astype(dtype)
    L = cfg.max_text_len
    ids = rng.integers(4, cfg.model.text.vocab_size - 2, (batch_size, L))
    ids[:, 0] = 0  # <s>
    lengths = rng.integers(4, L, batch_size)
    mask = np.zeros((batch_size, L), np.int32)
    for i, l in enumerate(lengths):
        ids[i, l - 1] = 2  # </s>
        ids[i, l:] = 1  # <pad>
        mask[i, :l] = 1
    vocab = cfg.model.text.vocab_size
    mlm_ids, mlm_labels = mask_tokens(
        ids, rng, cfg.mlm_prob, mask_id=min(50264, vocab - 1), vocab_size=vocab)
    noun = (rng.random((batch_size, NOUN_DIM)) < 0.005).astype(np.float32)
    verb = (rng.random((batch_size, VERB_DIM)) < 0.01).astype(np.float32)
    # ensure non-empty rows without making every pair a shared positive
    noun[np.arange(batch_size), rng.integers(0, min(20, NOUN_DIM), batch_size)] = 1
    verb[np.arange(batch_size), rng.integers(0, min(8, VERB_DIM), batch_size)] = 1
    return {
        "video": video,
        "text_ids": ids.astype(np.int32),
        "text_mask": mask,
        "text_mlm_ids": mlm_ids.astype(np.int32),
        "text_mlm_labels": mlm_labels.astype(np.int32),
        "noun_vec": noun,
        "verb_vec": verb,
    }


def tiny_train_config() -> TrainConfig:
    """Small-but-complete pretrain config: every architectural feature on
    (fusion blocks, both heads) at toy widths, `model.remat` on, as the
    JAX package's."""
    return TrainConfig(
        model=ModelConfig(
            video=VideoEncoderConfig(
                img_size=32, patch_size=16, embed_dim=32, depth=4,
                num_heads=2, num_frames=2,
            ),
            text=TextEncoderConfig(
                vocab_size=256, hidden_size=32, num_layers=4, num_heads=2,
                intermediate_size=64, max_position_embeddings=40,
            ),
            fusion=FusionConfig(num_fuse_block=2, dim_video=32, dim_text=32,
                                hidden_size=32),
            projection_dim=64,
            remat=True,
        ),
        optim=OptimConfig(max_steps=10),
        max_text_len=12,
    )


def build_pretrain(cfg: TrainConfig, device="cuda", loss_scale: float = 1.0):
    """Returns (model, optimizer, scheduler, train_step) on `device`.

    The parameters are `weights.training_init_` from a CPU generator
    seeded with `cfg.seed`, the same on every rank; dropout and the ITM
    mining draw from a generator on `device` seeded with `cfg.seed + 1`,
    which the step keeps as `train_step.generator` (over W > 1 ranks two,
    `parallel.mesh.train_generators`: the mining one is
    `train_step.mining_generator`)."""
    device = torch.device(device)
    model = EgoVLPv2(cfg.model, device=device)
    training_init_(model, torch.Generator().manual_seed(cfg.seed))
    optimizer, scheduler = make_optimizer(cfg.optim, model)
    generator, mining = train_generators(device, cfg.seed + 1)
    step = make_train_step(model, cfg, optimizer, scheduler, generator,
                           loss_scale=loss_scale, mining_generator=mining)
    return model, optimizer, scheduler, step
