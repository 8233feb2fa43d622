"""AdamW with the reference's 6 parameter groups + warmup schedules (port
of `egovlpv2_tpu/train/optimizer.py`; reference
`EgoVLPv2/set_optim_schedule.py:16-129`).

Groups are {backbone, heads x lr_mult_head, cross-modal x
lr_mult_cross_modal} x {decay, no-decay}, selected by substring rules over
the parameter's flax path (the port's dotted name goes through
`weights.flax_path`, so both packages label a parameter alike). Two
reference quirks are kept, as they affect training dynamics:

  * `norm3` (the video time-attention LN) is NOT in the no-decay list, so
    its scale gets weight decay;
  * the fusion gates alpha_i2t / alpha_t2i live in the cross-modal DECAY
    group (their names match "i2t"/"t2i" but not "bias").

`make_adamw_warmup_cosine` is the one-group optimizer of the EgoTaskQA
fine-tune (`optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup,
total), weight_decay=0.01)`): every parameter decays, biases and LayerNorm
scales included.

`torch.optim.AdamW` decays decoupled, p <- p (1 - lr wd), then steps by
lr m/(sqrt(v) + eps): the same update as optax's -lr (u + wd p). The
schedule is a `LambdaLR` whose factor at count c is optax's schedule at c
over the peak, so the first update runs at lr 0, as in optax.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from egovlpv2_torch.core.config import OptimConfig
from egovlpv2_torch.weights import flax_path

HEAD_NAMES = ("mlm_score", "itm_score", "txt_proj", "vid_proj")
CROSS_MODAL_NAMES = ("cross_modal", "i2t", "t2i")
# substrings over '.'-joined flax paths (the LN scale leaf is 'scale')
NO_DECAY_SUBSTR = ("bias", "LayerNorm", ".norm.", ".norm1.", ".norm2.")
GROUPS = ("backbone_wd", "backbone_nd", "head_wd", "head_nd", "cross_wd",
          "cross_nd")


def param_label(path: Tuple[str, ...]) -> str:
    """The group of the parameter at flax path `path`."""
    name = "." + ".".join(path) + "."
    nd = any(s in name for s in NO_DECAY_SUBSTR)
    is_head = any(h in name for h in HEAD_NAMES)
    is_cross = any(c in name for c in CROSS_MODAL_NAMES)
    if is_head and not is_cross:
        grp = "head"
    elif is_cross and not is_head:
        grp = "cross"
    else:
        grp = "backbone"
    return f"{grp}_{'nd' if nd else 'wd'}"


def label_parameters(model: nn.Module) -> Dict[str, str]:
    """The port's parameter name -> its group."""
    return {name: param_label(flax_path(name, p.dim()))
            for name, p in model.named_parameters()}


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """count -> learning rate over the peak (`cfg.lr` times the group's
    multiplier): linear warmup from 0, then cosine to 0 or a polynomial
    to `cfg.end_lr` over the peak."""
    warmup = max(int(cfg.warmup_frac * cfg.max_steps), 1) \
        if cfg.warmup_frac < 1 else int(cfg.warmup_frac)
    decay_steps = cfg.max_steps - warmup
    cosine = cfg.decay_power == "cosine"
    if not cosine:
        power = 1.0 if cfg.decay_power in ("poly1", "linear") \
            else float(cfg.decay_power)
        end = cfg.end_lr / cfg.lr

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        done = min(max(count - warmup, 0), decay_steps) / decay_steps
        if cosine:
            return 0.5 * (1.0 + math.cos(math.pi * done))
        return (1.0 - end) * (1.0 - done) ** power + end

    return factor


def param_groups(cfg: OptimConfig, model: nn.Module) -> List[dict]:
    """The six AdamW groups (empty ones left out), each with its peak lr
    and weight decay."""
    mult = {"backbone": 1.0, "head": cfg.lr_mult_head,
            "cross": cfg.lr_mult_cross_modal}
    members: Dict[str, list] = {g: [] for g in GROUPS}
    labels = label_parameters(model)
    for name, p in model.named_parameters():
        members[labels[name]].append(p)
    return [{"name": g, "params": ps, "lr": cfg.lr * mult[g.split("_")[0]],
             "weight_decay": cfg.weight_decay if g.endswith("_wd") else 0.0}
            for g, ps in members.items() if ps]


def make_optimizer(cfg: OptimConfig, model: nn.Module,
                   lr_scale: Optional[Callable[[int], float]] = None):
    """Returns (AdamW over the six groups, its LambdaLR). Step the
    scheduler once after every optimizer step. `cfg.grad_clip` is applied
    by the training step (`clip_grad_norm_`). `lr_scale(count)` multiplies
    the schedule (the fine-tunes' epoch-milestone decay,
    `tasks.retrieval.epoch_milestone_schedule`)."""
    optimizer = torch.optim.AdamW(param_groups(cfg, model), betas=cfg.betas,
                                  eps=cfg.eps)
    factor = make_schedule(cfg)
    if lr_scale is not None:
        base = factor
        factor = lambda count: base(count) * lr_scale(count)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler


def warmup_cosine_factor(warmup_steps: int, total_steps: int
                         ) -> Callable[[int], float]:
    """count -> `optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps)` at count, over the peak: linear from 0 over the warmup,
    then a cosine to 0 over the remaining `total_steps - warmup_steps`
    (which must be positive, as optax requires)."""
    decay_steps = total_steps - warmup_steps
    if not decay_steps > 0:
        raise ValueError(f"the cosine needs positive decay steps, got "
                         f"{total_steps} total - {warmup_steps} warmup")

    def factor(count: int) -> float:
        if count < warmup_steps:
            return count / warmup_steps
        done = min(count - warmup_steps, decay_steps) / decay_steps
        return 0.5 * (1.0 + math.cos(math.pi * done))

    return factor


def make_adamw_warmup_cosine(model: nn.Module, lr: float, warmup_steps: int,
                             total_steps: int, weight_decay: float = 0.01):
    """Returns (AdamW over all of `model`'s parameters in one group, its
    LambdaLR): optax.adamw's defaults, b1 0.9, b2 0.999, eps 1e-8 added
    after the square root; the schedule is read at the update count before
    the update, so the first update's learning rate is 0. Step the scheduler
    once after every optimizer step."""
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, warmup_cosine_factor(warmup_steps, total_steps))
    return optimizer, scheduler
