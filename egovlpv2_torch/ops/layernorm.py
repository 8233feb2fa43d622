"""LayerNorm with flax numerics (port of `egovlpv2_tpu/ops/layernorm.py`).

The statistics are float32 in flax's fast-variance form, E[x^2] - E[x]^2
clipped at 0, and the affine is float32 before the cast back
(`_ln_xla`). `torch.nn.functional.layer_norm` computes the variance
another way, so it is not used.

`layernorm` is one differentiable function that saves x and scale alone
and dispatches on the device of its input:
  * a CUDA tensor takes the hand-written kernels of `csrc/layernorm.cu`,
    forward (K7) and backward (K8, which recomputes the statistics), the
    twins of the JAX package's fused Pallas LN; a kernel that cannot build
    or launch, or a shape it does not take, raises;
  * a CPU tensor takes the plain PyTorch versions, `layernorm_reference`
    and `layernorm_backward_reference` (the backward's formulas written
    out, as the kernel computes them);
  * any other device raises.
The tests and `chip_smoke.py` hold K7 and K8 against the plain versions;
nothing on the card's path calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from egovlpv2_torch.ops import _kernels

# Inputs and cotangents that arrived as views and were copied before the
# kernels (or the plain versions) read them, since the last reset.
contiguous_copies = {"x": 0, "g": 0}


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = 1e-5
                        ) -> torch.Tensor:
    """Plain PyTorch LayerNorm over the last axis; returns x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layernorm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                 g: torch.Tensor, eps: float = 1e-5
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch backward of `layernorm_reference` from x, scale and the
    cotangent g of y, with the statistics recomputed: (dx in x.dtype,
    dscale and dbias float32 [D]). All arithmetic is float32."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gs = gf * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gs - m1 - xhat * m2)).to(x.dtype)
    d = x.shape[-1]
    dscale = (gf * xhat).reshape(-1, d).sum(dim=0)
    dbias = gf.reshape(-1, d).sum(dim=0)
    return dx, dscale, dbias


def _contiguous(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.is_contiguous():
        return t
    contiguous_copies[what] += 1
    return t.contiguous()


class _LayerNorm(torch.autograd.Function):
    """LayerNorm as one differentiable function of x [..., D], scale and
    bias [D]. Only x and scale are saved: the backward recomputes the
    statistics. On CUDA tensors K7 and K8 run, on CPU tensors their plain
    versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2 = _contiguous(x, "x").view(-1, x.shape[-1])
        if x2.device.type == "cpu":
            y = layernorm_reference(x2, scale, bias, eps=eps)
        else:
            y = torch.empty_like(x2)
            _kernels.layernorm_fwd(x2, scale, bias, y, eps=eps)
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        # Autograd may hand over a view (a slice's or an expand's gradient).
        g2 = _contiguous(g, "g").view(x2.shape)
        if x2.device.type == "cpu":
            dx, dscale, dbias = layernorm_backward_reference(x2, scale, g2,
                                                             ctx.eps)
        else:
            dx = torch.empty_like(x2)
            dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
            _kernels.layernorm_bwd(x2, scale, g2, dx, dscale, dbias,
                                   _kernels.layernorm_bwd_scratch(x2),
                                   eps=ctx.eps)
        return dx.view(g.shape), dscale, dbias, None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; returns x.dtype. scale and bias are
    float32 [D]."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layernorm runs on cpu or cuda, not {x.device}")
    return _LayerNorm.apply(x, scale, bias, eps)


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
