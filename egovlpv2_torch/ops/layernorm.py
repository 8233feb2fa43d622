"""LayerNorm with flax numerics (port of `egovlpv2_tpu/ops/layernorm.py`).

The statistics are float32 in flax's fast-variance form, E[x^2] - E[x]^2
clipped at 0, and the affine is float32 before the cast back
(`_ln_xla`). `torch.nn.functional.layer_norm` computes the variance
another way, so it is not used. The JAX package's fused Pallas LN is gated
off on its main path; its Hopper twin is still to be ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; returns x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """`nn.LayerNorm(epsilon, dtype)` of flax: f32 `weight` (flax `scale`)
    and `bias`; the input is cast to `dtype` first when one is given."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return layernorm(x, self.weight, self.bias, eps=self.eps)
