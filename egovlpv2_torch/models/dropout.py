"""`Dropout`: the counterpart of flax's `nn.Dropout`, drawing from an
explicit `torch.Generator`; and `checkpoint_region`, rematerialisation
that replays that generator's draws."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def checkpoint_region(fn: Callable,
                      generator: Optional[torch.Generator]) -> Callable:
    """`fn` as one checkpoint region: its activations are dropped after
    the forward and rebuilt in the backward. `checkpoint` restores only
    PyTorch's global generators for the rebuild, so the state of the
    model's own generator is put back here, and the rebuild draws the
    dropout masks of the first run."""
    first: Dict[str, torch.Tensor] = {}

    def run(*args):
        if generator is None:
            return fn(*args)
        if "state" not in first:
            first["state"] = generator.get_state()
            return fn(*args)
        now = generator.get_state()
        generator.set_state(first["state"])
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    return lambda *args: checkpoint(run, *args, use_reentrant=False)


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
