"""Parameters of the port: the bridge to and from the JAX package's flax
tree, and the seeded random fill.

Naming: a flax path becomes a torch name by joining with '.', and a module
name ending in `_<i>` (`blocks_0`, `layer_3`) becomes a list entry
(`blocks.0`, `layer.3`). Leaves, the inverse of the conventions of
`egovlpv2_tpu/train/checkpoint_import.py`:

  flax Dense `kernel` [in, out]      <-> torch `weight` [out, in]
  flax patch `kernel` [p, p, C, D]   <-> torch `weight`, the same HWIO array
  flax LayerNorm `scale`             <-> torch `weight`
  flax Embed `embedding`             <-> torch `weight` of a `*_embeddings`
  any other leaf (`bias`, `cls_token`, `alpha_i2t`, ...) keeps its name.

Only numpy and torch are used here.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

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


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """The port's state_dict -> flax parameter tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *parts, leaf = name.split(".")
        mods = []
        for part in parts:
            if part.isdigit():
                mods[-1] = f"{mods[-1]}_{part}"
            else:
                mods.append(part)
        arr = tensor.detach().cpu().numpy()
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            elif arr.ndim == 4:
                leaf = "kernel"
            elif mods[-1].endswith("embeddings"):
                leaf = "embedding"
            else:
                leaf, arr = "kernel", arr.T
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
