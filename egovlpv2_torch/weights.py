"""Parameters of the port: the bridge to and from the JAX package's flax
tree, and the seeded fills.

Naming: a flax path becomes a torch name by joining with '.', and a module
name ending in `_<i>` (`blocks_0`, `layer_3`) becomes a list entry
(`blocks.0`, `layer.3`). Leaves, the inverse of the conventions of
`egovlpv2_tpu/train/checkpoint_import.py`:

  flax Dense `kernel` [in, out]      <-> torch `weight` [out, in]
  flax patch `kernel` [p, p, C, D]   <-> torch `weight`, the same HWIO array
  flax LayerNorm `scale`             <-> torch `weight`
  flax Embed `embedding`             <-> torch `weight` of a `*_embeddings`
  any other leaf (`bias`, `cls_token`, `alpha_i2t`, ...) keeps its name.

The bridge carries any tree shaped like the parameters: a flax tree of
gradients goes through `state_dict_from_flax` into the port's names and
layouts (the same transposes), so the tests compare gradients and updated
parameters name by name. `flax_path` gives one parameter's flax path; the
optimizer's group rules are written over those paths.

Only numpy and torch are used here.
"""

from __future__ import annotations

import re
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from egovlpv2_torch.ops.layernorm import LayerNorm

_LIST_ENTRY = re.compile(r"^(.*)_(\d+)$")
_INIT_STD = 0.02  # std of `random_init_`'s normal draws


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax parameter tree (nested dict of arrays) -> the port's state_dict."""
    out = {}
    for path, value in _flatten(params):
        *mods, leaf = path
        names = [_LIST_ENTRY.sub(r"\1.\2", m) for m in mods]
        arr = np.asarray(value)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(names + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr).copy())
    return out


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the port's parameter `name` with `ndim` axes."""
    *parts, leaf = name.split(".")
    mods = []
    for part in parts:
        if part.isdigit():
            mods[-1] = f"{mods[-1]}_{part}"
        else:
            mods.append(part)
    if leaf == "weight":
        if ndim == 1:
            leaf = "scale"
        elif mods[-1].endswith("embeddings"):
            leaf = "embedding"
        else:
            leaf = "kernel"
    return (*mods, leaf)


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """The port's state_dict -> flax parameter tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        *mods, leaf = flax_path(name, arr.ndim)
        if leaf == "kernel" and arr.ndim == 2:
            arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr).copy()
    return tree


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in place, on any device.

    Weights, biases and embeddings are normal(0, _INIT_STD); LayerNorm
    scales are 1 + normal(0, _INIT_STD); the i2t/t2i gates are 0.5. Unlike
    the training init of the JAX package (zero gates, zero time-attention
    qkv), every path of the model then carries signal, as an evaluation
    without a checkpoint needs. Draws are made on the CPU, so a seed gives the same parameters
    on every device.
    """
    ln_weights = {id(m.weight) for m in model.modules() if isinstance(m, LayerNorm)}
    for name, p in model.named_parameters():
        value = torch.randn(p.shape, generator=generator) * _INIT_STD
        if name.endswith(("alpha_i2t", "alpha_t2i")):
            value.fill_(0.5)
        elif id(p) in ln_weights:
            value += 1.0
        p.copy_(value)
    return model


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) cut at two standard deviations, by redrawing."""
    value = torch.randn(shape, generator=generator)
    while True:
        bad = value.abs() > 2.0
        if not bad.any():
            return value * std
        value = torch.where(bad, torch.randn(shape, generator=generator), value)


@torch.no_grad()
def training_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter the way the JAX package initialises a model for
    training (`init_all`; its distributions, not its draws), in place:

    Dense weights lecun-normal (truncated normal, variance 1/fan_in) and
    biases 0; embeddings and the cross-modal transforms normal(0, 0.02);
    `cls_token` and `pos_embed` of the video tower truncated normal(0,
    0.02); `temporal_embed`, the fused path's `cls_token` and the i2t/t2i
    gates 0; LayerNorm scales 1; the time attention starts as the identity
    the reference gives it: qkv weight and bias 0, proj weight all ones.
    Draws are made on the CPU, so a seed gives the same parameters on every
    device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("video_model.cls_token", "video_model.pos_embed"):
            value = _trunc_normal(p.shape, _INIT_STD, generator)
        elif leaf == "weight" and p.dim() == 1:
            value = torch.ones(p.shape)
        elif leaf != "weight" or ".timeattn.qkv." in name:
            value = torch.zeros(p.shape)
        elif ".timeattn.proj." in name:
            value = torch.ones(p.shape)
        elif "embeddings." in name or name.startswith("cross_modal") \
                and "transform" in name:
            value = torch.randn(p.shape, generator=generator) * _INIT_STD
        else:  # Dense [out, in], or the patch kernel [p, p, C, D]
            fan_in = p.shape[1] if p.dim() == 2 else math.prod(p.shape[:3])
            # lecun_normal: a truncated normal rescaled to variance 1/fan_in
            value = _trunc_normal(p.shape, math.sqrt(1.0 / fan_in)
                                  / 0.87962566103423978, generator)
        p.copy_(value)
    return model
