"""VSLNet temporal-grounding head for EgoNLQ (port of
`egovlpv2_tpu/downstream/vslnet.py`).

Capability-parity target: `EgoNLQ/model/VSLNet.py:59-145` +
`EgoNLQ/model/layers.py`: VisualProjection -> shared FeatureEncoder
(positional embedding + 4x depthwise-separable conv + multi-head attention)
-> CQAttention (trilinear context/query attention) -> CQConcatenate
(weighted-pooled query) -> HighLightLayer (weighted BCE) -> Conditioned
start/end predictor ('EgoVLP' predictor variant: encoder reused twice +
layer norms). Sequences are masked to static max lengths.

Float32 throughout. Every LayerNorm is `ops.layernorm.LayerNorm(dim, eps=1e-6)`
(flax's fast variance, E[x^2] - E[x]^2), so on a CUDA tensor it runs the
hand-written K7 forward and K8 backward. The attention is plain PyTorch, as
the JAX head has it: its mask is additive -1e30 and, in training, dropout
acts on its probabilities, neither of which the fused attention kernel
takes. The feature encoder is one module called for the query and the
video, the predictor encoder one module called twice; the encoders are
built without dropout, as the JAX `VSLNet` builds them (it does not pass
its rate on), so dropout acts on the video input and inside `CQAttention`.
Dropout draws from the generator given to `set_generator`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from egovlpv2_torch.downstream.vsgn import Conv
from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.dropout import Dropout
from egovlpv2_torch.ops.layernorm import LayerNorm

MASK_NEG = -1e30
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def mask_logits(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x + (1.0 - mask.to(x.dtype)) * MASK_NEG


class DepthwiseSeparableConvBlock(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 7, num_layers: int = 4,
                 drop_rate: float = 0.0, device=None):
        super().__init__()
        self.ln = nn.ModuleList([LayerNorm(dim, eps=LN_EPS, device=device)
                                 for _ in range(num_layers)])
        self.depthwise = nn.ModuleList([
            Conv(dim, dim, kernel_size, groups=dim, bias=False, device=device)
            for _ in range(num_layers)])
        self.pointwise = nn.ModuleList([Conv(dim, dim, 1, device=device)
                                        for _ in range(num_layers)])
        self.dropout = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for ln, depthwise, pointwise in zip(self.ln, self.depthwise,
                                            self.pointwise):
            out = torch.relu(pointwise(depthwise(ln(x))))
            x = self.dropout(out) + x
        return x


class MultiHeadAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, drop_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.ln2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.query = Dense(dim, dim, device=device)
        self.key = Dense(dim, dim, device=device)
        self.value = Dense(dim, dim, device=device)
        self.out_layer = Dense(dim, dim, device=device)
        self.dropout = Dropout(drop_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, s, dim = x.shape
        h = self.num_heads
        dh = dim // h
        out = self.dropout(self.ln1(x))

        def heads(t):
            return t.reshape(b, s, h, dh).transpose(1, 2)

        q, k, v = (heads(proj(out)) for proj in (self.query, self.key,
                                                   self.value))
        scores = q @ k.transpose(-1, -2) / math.sqrt(dh)
        if mask is not None:
            scores = mask_logits(scores, mask[:, None, None, :])
        probs = self.dropout(torch.softmax(scores, dim=-1))
        val = (probs @ v).transpose(1, 2).reshape(b, s, dim)
        residual = self.dropout(val) + x
        out = self.out_layer(self.dropout(self.ln2(residual)))
        return self.dropout(out) + residual


class FeatureEncoder(nn.Module):
    def __init__(self, dim: int, num_heads: int, max_pos_len: int,
                 kernel_size: int = 7, num_layers: int = 4,
                 drop_rate: float = 0.0, device=None):
        super().__init__()
        self.pos_embedding = nn.Embedding(max_pos_len, dim, device=device)
        self.conv_block = DepthwiseSeparableConvBlock(
            dim, kernel_size, num_layers, drop_rate, device=device)
        self.attention_block = MultiHeadAttentionBlock(dim, num_heads,
                                                       drop_rate, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.pos_embedding.weight[:x.shape[1]]
        return self.attention_block(self.conv_block(x), mask)


class CQAttention(nn.Module):
    def __init__(self, dim: int, drop_rate: float = 0.0, device=None):
        super().__init__()
        # flax shapes; `weights.flax_init_` draws them xavier-uniform
        self.w4C = nn.Parameter(torch.empty(dim, 1, device=device))
        self.w4Q = nn.Parameter(torch.empty(dim, 1, device=device))
        self.w4mlu = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.cqa_linear = Dense(4 * dim, dim, device=device)
        self.dropout = Dropout(drop_rate)

    def forward(self, context, query, c_mask, q_mask):
        c, q = self.dropout(context), self.dropout(query)
        s0 = c @ self.w4C  # [B, Sc, 1]
        s1 = (q @ self.w4Q).transpose(1, 2)  # [B, 1, Sq]
        s2 = (c * self.w4mlu) @ q.transpose(1, 2)
        score = s0 + s1 + s2  # [B, Sc, Sq]
        score_ = torch.softmax(mask_logits(score, q_mask[:, None, :]), dim=2)
        score_t = torch.softmax(mask_logits(score, c_mask[:, :, None]),
                                dim=1).transpose(1, 2)
        c2q = score_ @ query
        q2c = (score_ @ score_t) @ context
        out = torch.cat([context, c2q, context * c2q, context * q2c], dim=2)
        return self.cqa_linear(out)


class CQConcatenate(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.pool_weight = nn.Parameter(torch.empty(dim, 1, device=device))
        self.conv1d = Dense(2 * dim, dim, device=device)

    def forward(self, context, query, q_mask):
        alpha = torch.softmax(mask_logits(query @ self.pool_weight,
                                          q_mask[:, :, None]), dim=1)
        pooled = (alpha.transpose(1, 2) @ query)[:, 0]  # [B, dim]
        pooled = pooled[:, None, :].expand(-1, context.shape[1], -1)
        return self.conv1d(torch.cat([context, pooled], dim=2))


class HighLightLayer(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1d = Dense(dim, 1, device=device)

    def forward(self, x, mask):
        return torch.sigmoid(mask_logits(self.conv1d(x)[:, :, 0], mask))

    @staticmethod
    def loss(scores, labels, mask, eps=1e-12):
        labels = labels.float()
        weights = torch.where(labels == 0.0, torch.ones_like(labels),
                              2.0 * labels)
        s = torch.clamp(scores, eps, 1.0 - eps)
        bce = -(labels * torch.log(s) + (1 - labels) * torch.log(1 - s))
        mask = mask.float()
        return torch.sum(bce * weights * mask) / (torch.sum(mask) + eps)


class VSLNet(nn.Module):
    def __init__(self, dim: int = 128, num_heads: int = 8,
                 max_pos_len: int = 256, video_feature_dim: int = 768,
                 query_feature_dim: int = 768, drop_rate: float = 0.2,
                 device=None):
        super().__init__()
        self.dim, self.max_pos_len = dim, max_pos_len
        self.video_affine = Dense(video_feature_dim, dim, device=device)
        self.query_affine = Dense(query_feature_dim, dim, device=device)
        self.feature_encoder = FeatureEncoder(dim, num_heads, max_pos_len,
                                              device=device)
        self.cq_attention = CQAttention(dim, drop_rate, device=device)
        self.cq_concat = CQConcatenate(dim, device=device)
        self.highlight_layer = HighLightLayer(dim, device=device)
        self.predictor_encoder = FeatureEncoder(dim, num_heads, max_pos_len,
                                                device=device)
        self.start_layer_norm = LayerNorm(dim, eps=LN_EPS, device=device)
        self.end_layer_norm = LayerNorm(dim, eps=LN_EPS, device=device)
        for side in ("start", "end"):
            setattr(self, f"{side}_fc0", Dense(2 * dim, dim, device=device))
            setattr(self, f"{side}_fc1", Dense(dim, 1, device=device))
        self.dropout = Dropout(drop_rate)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout mask in training mode comes from `generator`."""
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = generator

    def forward(self, video_features, v_mask, query_features, q_mask):
        v = self.video_affine(self.dropout(video_features))
        q = self.query_affine(query_features)
        q = self.feature_encoder(q, q_mask)
        v = self.feature_encoder(v, v_mask)
        feats = self.cq_attention(v, q, v_mask, q_mask)
        feats = self.cq_concat(feats, q, q_mask)
        h_score = self.highlight_layer(feats, v_mask)
        feats = feats * h_score[:, :, None]

        start_f = self.predictor_encoder(feats, v_mask)
        end_f = self.predictor_encoder(start_f, v_mask)
        start_f = self.start_layer_norm(start_f)
        end_f = self.end_layer_norm(end_f)

        def block(side, feat):
            x = torch.relu(getattr(self, f"{side}_fc0")(
                torch.cat([feat, feats], dim=2)))
            return getattr(self, f"{side}_fc1")(x)[:, :, 0]

        start_logits = mask_logits(block("start", start_f), v_mask)
        end_logits = mask_logits(block("end", end_f), v_mask)
        return h_score, start_logits, end_logits


def span_loss(start_logits, end_logits, start_labels, end_labels):
    def ce(logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))

    return ce(start_logits, start_labels) + ce(end_logits, end_labels)


def extract_top_spans(start_logits: torch.Tensor, end_logits: torch.Tensor,
                      k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (start, end) with end >= start via upper-triangular outer product
    (VSLNet.py:555-571); equal scores go to the lower flat index, as
    `lax.top_k`'s do (a stable sort)."""
    sp = torch.softmax(start_logits, dim=1)
    ep = torch.softmax(end_logits, dim=1)
    outer = torch.triu(sp[:, :, None] * ep[:, None, :])
    b, _, w = outer.shape
    idx = torch.sort(outer.reshape(b, -1), dim=1, descending=True,
                     stable=True).indices[:, :k]
    return idx // w, idx % w
