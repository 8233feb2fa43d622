"""Task heads: Pooler, ITM, MLM (port of `egovlpv2_tpu/models/heads.py`)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.ops.layernorm import LayerNorm


class Pooler(nn.Module):
    """dense + tanh over an already-pooled feature."""

    def __init__(self, hidden_size: int, dtype=None, device=None):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x))


class ITMHead(nn.Module):
    """Linear -> 2 logits over concat(text_pool, video_pool)."""

    def __init__(self, in_features: int, dtype=None, device=None):
        super().__init__()
        self.fc = Dense(in_features, 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class MLMHead(nn.Module):
    """dense + gelu + LN (eps 1e-12), then a vocab decoder with its own bias."""

    def __init__(self, hidden_size: int, vocab_size: int, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.transform_dense = Dense(hidden_size, hidden_size, **kw)
        self.transform_LayerNorm = LayerNorm(hidden_size, eps=1e-12, **kw)
        self.decoder = Dense(hidden_size, vocab_size, bias=False, **kw)
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transform_LayerNorm(F.gelu(self.transform_dense(x)))
        logits = self.decoder(x)
        return logits + self.bias.to(logits.dtype)
