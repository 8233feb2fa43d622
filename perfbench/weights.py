"""Seeded weights, drawn on the device in a few large calls.

The distributions of a model initialised for training (EgoVLPv2's recipe,
as the port's `weights.training_init_` states them; its draws are not
reproduced): Dense and patch weights lecun-normal (a normal cut at two
standard deviations, rescaled to variance 1 / fan_in) and biases 0;
embeddings and the cross-modal transforms normal(0, 0.02); the video
tower's `cls_token` and `pos_embed` normal(0, 0.02) cut at two standard
deviations; `temporal_embed`, the fused path's `cls_token` and the fusion
gates 0; LayerNorm scales 1; the time attention starting as the identity
(qkv 0, proj weight all ones).

`init_kind` gives those rules by EgoVLPv2's parameter names; a task
(`perfbench/tasks/<task>.py`) names the rules of its model as its own
`init_kind`, which `make_weights` takes. Every cut normal of the model
comes from one uniform draw through the inverse normal CDF and every plain
normal from one normal draw, each over the leaves in the order of their
sorted names, so the same seed gives the same tensors on the same device
whatever module holds them. The program and the reference are both filled
from `make_weights`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

import torch

INIT_STD = 0.02
_CUT = 2.0  # standard deviations


def init_kind(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """(kind, number) of EgoVLPv2's parameter `name`: kind is "cut" (cut
    normal) or "normal" with the number its standard deviation, "zeros"
    or "ones" (the number unread), or "fill" with the number its value."""
    leaf = name.rsplit(".", 1)[-1]
    if name in ("video_model.cls_token", "video_model.pos_embed"):
        return "cut", INIT_STD
    if leaf == "weight" and len(shape) == 1:
        return "ones", 0.0
    if leaf != "weight" or ".timeattn.qkv." in name:
        return "zeros", 0.0
    if ".timeattn.proj." in name:
        return "ones", 0.0
    if "embeddings." in name or (name.startswith("cross_modal")
                                 and "transform" in name):
        return "normal", INIT_STD
    fan_in = shape[1] if len(shape) == 2 else math.prod(shape[:3])
    return "cut", math.sqrt(1.0 / fan_in) / 0.87962566103423978


def _cut_normal_(u: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) draws -> standard normal draws cut at +-_CUT, in
    place (the inverse CDF over the kept interval)."""
    lo = 0.5 * (1.0 + math.erf(-_CUT / math.sqrt(2.0)))
    hi = 1.0 - lo
    return u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_().mul_(
        math.sqrt(2.0)).clamp_(-_CUT, _CUT)


def make_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int, device,
                 kind_of: Callable[[str, Tuple[int, ...]], Tuple[str, float]]
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`, drawn from `seed` by the rules
    `kind_of(name, shape)` (`init_kind`'s kinds). The tensors of one random
    kind are views of one buffer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = {n: kind_of(n, tuple(s)) for n, s in shapes.items()}
    out: Dict[str, torch.Tensor] = {}
    for kind in ("cut", "normal"):
        names = sorted(n for n, (k, _) in kinds.items() if k == kind)
        total = sum(math.prod(shapes[n]) for n in names)
        if not total:
            continue
        if kind == "cut":
            flat = _cut_normal_(torch.rand(total, generator=gen,
                                           device=device))
        else:
            flat = torch.randn(total, generator=gen, device=device)
        at = 0
        for n in names:
            size = math.prod(shapes[n])
            out[n] = flat[at:at + size].view(shapes[n]).mul_(kinds[n][1])
            at += size
    for n, (kind, value) in kinds.items():
        if kind == "zeros":
            out[n] = torch.zeros(shapes[n], device=device)
        elif kind == "ones":
            out[n] = torch.ones(shapes[n], device=device)
        elif kind == "fill":
            out[n] = torch.full(shapes[n], float(value), device=device)
        elif kind not in ("cut", "normal"):
            raise ValueError(f"{n}: no weight kind {kind!r}")
    return out
