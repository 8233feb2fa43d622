"""Attention primitives shared by the encoders (port of
`egovlpv2_tpu/ops/attention.py`).

`attend` is softmax(scale * q @ k^T + bias) @ v and dispatches as the JAX
package's does:
  * without probability dropout (every attention at evaluation, and the
    i2t cross-attention always) it is `ops.flash.flash_attention`: the
    hand-written fused kernel on a CUDA tensor, its plain version on a CPU
    tensor, all arithmetic float32 and one cast at the end;
  * with probability dropout (text attention in training, p = 0.1) it is
    the plain code below with the flax dtype rules written out: q is scaled
    in its own dtype, the logits and the softmax are float32, the
    probabilities are dropped and the PV product is stored in the compute
    dtype; autograd differentiates it.

The JAX package hands attentions under 32 tokens (all of its configurations
tokenize at 15 or 30) from its Pallas kernel back to XLA, because on the
TPU that kernel runs one grid step a (group, query tile) in order and is
bound by their launch at such lengths. A CUDA grid runs its blocks side by
side, so the port keeps no such rule: the kernel serves every length, and
`model.attn_impl` stays ignored.
"""

from __future__ import annotations

from typing import Optional

import torch

from egovlpv2_torch.ops.flash import flash_attention

# Additive mask value: zero after an f32 softmax, finite in bf16.
NEG_INF = -1e9


def make_additive_mask(attention_mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} padding mask -> [B, 1, 1, S] additive bias (0 keep / NEG_INF drop)."""
    bias = (1.0 - attention_mask.to(dtype)) * NEG_INF
    return bias[:, None, None, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
           bias: Optional[torch.Tensor] = None, prob_dropout: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scaled dot-product attention over the last two axes.

    q [..., Sq, Dh], k and v [..., Sk, Dh]; `bias` is additive and
    broadcasts to [..., Sq, Sk]. Returns [..., Sq, Dh] in q.dtype.

    `prob_dropout` > 0 drops attention probabilities (the reference trains
    text attention with p = 0.1): a Bernoulli keep-mask with probability
    1 - p drawn from `generator` (None: PyTorch's global one), kept
    probabilities divided by 1 - p. Without it the fused path runs, which
    takes a bias that is constant over Sq only.
    """
    if prob_dropout == 0.0:
        return flash_attention(q, k, v, scale=scale, bias=bias)
    return attend_plain(q, k, v, scale=scale, bias=bias,
                        prob_dropout=prob_dropout, generator=generator)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 scale: float, bias: Optional[torch.Tensor] = None,
                 prob_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`attend` in plain PyTorch ops with the flax dtype rules, on any
    device: the path of probability dropout, and the attention inside the
    plain versions of the divided-attention kernels."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    # bf16 products are exact in f32, so an f32 matmul of the upcast
    # operands is the bf16-in / f32-accumulate product of the reference.
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    if prob_dropout > 0.0:
        keep = 1.0 - prob_dropout
        mask = torch.rand(probs.shape, device=probs.device,
                          generator=generator) < keep
        probs = torch.where(mask, probs / keep, torch.zeros_like(probs))
    return torch.matmul(probs.to(q.dtype), v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*Dh] -> [B, H, S, Dh]."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)
