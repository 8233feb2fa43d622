"""`Dropout`: the counterpart of flax's `nn.Dropout`, drawing from an
explicit `torch.Generator`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    """Identity at eval or at rate 0; in training keeps each element with
    probability 1 - rate and divides the kept ones by it, as flax does.

    `generator` is set by the model's `set_generator`; None draws from
    PyTorch's global generator of the input's device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
