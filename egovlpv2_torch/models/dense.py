"""`Dense`: the counterpart of flax's `nn.Dense(dtype=...)`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


class Dense(nn.Linear):
    """nn.Linear with flax's dtype rule: float32 parameters, and the input,
    weight and bias cast to the compute dtype for the product.

    `weight` is [out, in] (the transpose of the flax kernel)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)
