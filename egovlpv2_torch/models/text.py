"""RoBERTa-base text encoder with gated t2i cross-modal fusion (port of
`egovlpv2_tpu/models/text.py`).

As in the JAX package and the reference `EgoVLPv2/model/roberta.py`:
  * fused layers carry a second attention whose K/V come from the video
    tokens, unmasked;
  * the layer is post-LN over (self + alpha_t2i * cross + residual);
  * `last_norm=False` skips the final FFN LayerNorm (its parameters stay);
  * position ids skip padding: cumsum(mask) * mask + pad_idx.

In `train()` mode the hidden dropout (`cfg.hidden_dropout`, after the
embeddings, the attention output and the FFN output) and the dropout of
the attention probabilities (`cfg.attn_dropout`) are on; both draw from
the generator `EgoVLPv2.set_generator` hands them. With `remat` every
layer is one checkpoint region in `train()` mode (flax's
`nn.remat(TextLayer)`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from egovlpv2_torch.core.config import FusionConfig, TextEncoderConfig
from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.dropout import Dropout, checkpoint_region
from egovlpv2_torch.ops.attention import (attend, make_additive_mask,
                                          merge_heads, split_heads)
from egovlpv2_torch.ops.layernorm import LayerNorm


def create_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d,
                                                  device=device)
        self.LayerNorm = LayerNorm(d, eps=cfg.ln_eps, dtype=dtype,
                                   device=device)
        self.drop = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        word = self.word_embeddings(input_ids)
        pos = self.position_embeddings(
            create_position_ids(input_ids, self.cfg.pad_token_id))
        ttype = self.token_type_embeddings(torch.zeros_like(input_ids))
        x = word + ttype + pos  # f32 sum, then the compute dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        return self.drop(self.LayerNorm(x))


class TextSelfAttention(nn.Module):
    """Q from text; K/V from text (self) or from video tokens (cross, kv_dim set)."""

    def __init__(self, cfg: TextEncoderConfig, kv_dim: Optional[int] = None,
                 dtype=None, device=None):
        super().__init__()
        d = cfg.hidden_size
        kv_dim = kv_dim or d
        self.num_heads = cfg.num_heads
        self.scale = cfg.head_dim ** -0.5
        self.attn_dropout = cfg.attn_dropout
        self.generator: Optional[torch.Generator] = None
        self.drop = Dropout(cfg.hidden_dropout)
        kw = dict(dtype=dtype, device=device)
        self.query = Dense(d, d, **kw)
        self.key = Dense(kv_dim, d, **kw)
        self.value = Dense(kv_dim, d, **kw)
        self.out_dense = Dense(d, d, **kw)

    def forward(self, hidden: torch.Tensor, kv_source: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.num_heads
        q = split_heads(self.query(hidden), h)
        k = split_heads(self.key(kv_source), h)
        v = split_heads(self.value(kv_source), h)
        out = attend(q, k, v, scale=self.scale, bias=bias,
                     prob_dropout=self.attn_dropout if self.training else 0.0,
                     generator=self.generator)
        return self.drop(self.out_dense(merge_heads(out)))


class TextLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, fusion: FusionConfig,
                 fused: bool, dtype=None, device=None):
        super().__init__()
        self.fused = fused
        d = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.attention = TextSelfAttention(cfg, **kw)
        if fused:
            self.crossattention_t2i = TextSelfAttention(
                cfg, kv_dim=fusion.dim_video, **kw)
            self.alpha_t2i = nn.Parameter(torch.zeros(1, device=device))
        self.attention_LayerNorm = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.intermediate = Dense(d, cfg.intermediate_size, **kw)
        self.output = Dense(cfg.intermediate_size, d, **kw)
        self.output_LayerNorm = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.drop = Dropout(cfg.hidden_dropout)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor] = None,
                video: Optional[torch.Tensor] = None,
                last_norm: bool = True) -> torch.Tensor:
        attn_out = self.attention(hidden, hidden, bias=bias)
        if self.fused and video is not None:
            cross = self.crossattention_t2i(attn_out, video, bias=None)
            attn_out = self.alpha_t2i.to(attn_out.dtype) * cross + attn_out
        # Post-LN over (self + gated cross + residual), roberta.py:488.
        attn_out = self.attention_LayerNorm(attn_out + hidden)
        out = self.drop(self.output(F.gelu(self.intermediate(attn_out))))
        out = out + attn_out
        return self.output_LayerNorm(out) if last_norm else out


class TextEncoder(nn.Module):
    """The text tower, with staged execution for the fused paths."""

    def __init__(self, cfg: TextEncoderConfig, fusion: FusionConfig,
                 dtype=None, device=None, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.generator: Optional[torch.Generator] = None
        kw = dict(dtype=dtype, device=device)
        self.embeddings = TextEmbeddings(cfg, **kw)
        num_unfused = cfg.num_layers - fusion.num_fuse_block
        self.layer = nn.ModuleList(
            TextLayer(cfg, fusion, fused=(i >= num_unfused), **kw)
            for i in range(cfg.num_layers))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(input_ids)

    def run_layers(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                   start: int = 0, end: Optional[int] = None,
                   video: Optional[torch.Tensor] = None,
                   last_norm: bool = True) -> torch.Tensor:
        end = self.cfg.num_layers if end is None else end
        for i in range(start, end):
            ln = last_norm if i == end - 1 else True
            hidden = self.run_layer(hidden, i, bias, video, ln)
        return hidden

    def run_layer(self, hidden, i, bias=None, video=None, last_norm=True):
        layer = self.layer[i]
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint_region(
                lambda hidden, bias, video: layer(hidden, bias, video,
                                                  last_norm),
                self.generator)(hidden, bias, video)
        return layer(hidden, bias, video, last_norm)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """Dual-tower forward over all layers -> last hidden state [B, S, D]."""
        bias = make_additive_mask(attention_mask)
        return self.run_layers(self.embed(input_ids), bias)
