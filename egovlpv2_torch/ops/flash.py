"""Fused attention (port of `egovlpv2_tpu/ops/flash.py`).

`flash_attention` is softmax((q * scale) @ k^T + bias) @ v as one
differentiable function that keeps the [Sq, Sk] logits out of device
memory. It saves q, k, v and the bias alone and dispatches on the device
of its input:
  * a CUDA tensor takes the hand-written kernel of
    `csrc/fused_attention.cu` (K9), the twin of the JAX package's Pallas
    `_attention_kernel`; a kernel that cannot build or launch, or a shape it
    does not take, raises;
  * a CPU tensor takes the plain PyTorch version,
    `flash_attention_reference`;
  * any other device raises.
The backward is what the JAX package's is (`_flash_3d_bwd`): the
probabilities recomputed and four float32 matrix products in plain PyTorch,
no kernel; the bias gets no gradient.

The kernel reads q, k and v by their strides (transposed views of a
[B, S, H*Dh] projection, slices of a packed [B, S, 2, H, Dh] one) and
writes [B, Sq, H, Dh], so that `merge_heads` of the result is a view.
`contiguous_copies` counts the inputs that had to be copied all the same.

The tests and `chip_smoke.py` hold K9 against the plain version; nothing on
the card's path calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from egovlpv2_torch.ops import _kernels

# Inputs the kernel could not read by stride (a head dim that is not
# contiguous, rows off 16-byte alignment, leading axes that do not fold into
# one without a copy, a bias that is not float32) and that were copied
# first, since the last reset.
contiguous_copies = {"q": 0, "k": 0, "v": 0, "bias": 0}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic: float32
    throughout (q scaled after the upcast, the probabilities never
    rounded), one cast to q.dtype at the end. (In bf16 at head dims 32, 64
    and 128 the kernel runs on the tensor cores and feeds P to P.V as the
    sum of two bf16 terms, 16 bits of mantissa; `attend_plain` rounds P to
    bf16. Held to this version on float32 copies of the inputs, the kernel
    differs by the one rounding of its output.)"""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def _check_bias(bias: torch.Tensor, lead: Tuple[int, ...], sq: int,
                sk: int) -> None:
    """`bias` must broadcast to [*lead, Sq, Sk] and be the same for every
    query row: [..., 1, Sk]."""
    if bias.dim() < 2 or bias.shape[-2] != 1:
        raise ValueError(
            f"flash_attention takes a bias that is constant over the queries "
            f"([..., 1, Sk], a padding mask), got {tuple(bias.shape)} for Sq="
            f"{sq}, Sk={sk}")
    blead = tuple(bias.shape[:-2])
    if bias.shape[-1] != sk or len(blead) > len(lead) or any(
            n not in (1, m) for n, m in zip(blead[::-1], lead[::-1])):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"{(*lead, sq, sk)}")


def _fold(t: torch.Tensor, what: str) -> torch.Tensor:
    """[..., S, Dh] -> [B, H, S, Dh], as a view where the leading axes
    allow it."""
    if t.dim() == 4:
        return t
    if t.dim() < 4:
        return t[(None,) * (4 - t.dim())]
    shape = (-1, *t.shape[-3:])
    try:
        return t.view(shape)
    except RuntimeError:
        contiguous_copies[what] += 1
        return t.reshape(shape)


def _strided(t: torch.Tensor, what: str) -> torch.Tensor:
    """`t` [B, H, S, Dh] if the kernel can read it by stride, else a copy."""
    if _kernels.attention_strides(t) is not None:
        return t
    contiguous_copies[what] += 1
    return t.contiguous()


def _launch(q, k, v, bias, scale) -> torch.Tensor:
    lead, (sq, dh) = q.shape[:-2], q.shape[-2:]
    q4, k4, v4 = (_strided(_fold(t, what), what)
                  for t, what in ((q, "q"), (k, "k"), (v, "v")))
    b, h = q4.shape[:2]
    if bias is not None:
        if bias.dim() != 4 or q.dim() != 4:  # any rank -> [B, H, 1, Sk]
            bias = _fold(bias.expand(*lead, 1, bias.shape[-1]), "bias")
        if bias.dtype != torch.float32 or (bias.shape[-1] > 1
                                           and bias.stride(-1) != 1):
            contiguous_copies["bias"] += 1
            bias = bias.float().contiguous()
    # [B, H, Sq, Dh] over a [B, Sq, H, Dh] buffer: the heads merged in memory
    out = torch.empty_strided((b, h, sq, dh),
                              (sq * h * dh, dh, h * dh, 1), dtype=q.dtype,
                              device=q.device)
    _kernels.fused_attention_fwd(q4, k4, v4, bias, out, scale=scale)
    return out if q.dim() == 4 else out.reshape(*lead, sq, dh)


class _FlashAttention(torch.autograd.Function):
    """Fused attention as one differentiable function of q, k and v. On
    CUDA tensors K9 runs, on CPU tensors its plain version; the backward
    recomputes the probabilities in float32."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, scale=scale, bias=bias)
        else:
            out = _launch(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        scale = ctx.scale
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        logits = torch.matmul(qf * scale, kf.transpose(-1, -2))
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1)
        dv = torch.matmul(probs.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = (dp - (dp * probs).sum(dim=-1, keepdim=True)) * (probs * scale)
        dq = torch.matmul(ds, kf)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention over the last two axes without probability dropout.

    q [..., Sq, Dh], k and v [..., Sk, Dh] with the same leading axes,
    float32 or bfloat16, Dh a multiple of 8 up to 128, Sq and Sk >= 1;
    `bias` is additive, broadcastable to [..., Sq, Sk] and constant over Sq
    (shape [..., 1, Sk]: a padding mask), or None. Returns [..., Sq, Dh] in
    q.dtype. Anything else raises a ValueError with the shapes: the JAX
    function silently takes the first row of a bias that varies over Sq.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if q.dim() < 2 or k.shape != v.shape or k.dim() != q.dim() \
            or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention takes q [..., Sq, Dh] and k, v "
                         f"[..., Sk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    sq, dh = q.shape[-2:]
    sk = k.shape[-2]
    if dh % 8 or not 8 <= dh <= 128 or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention takes a head dim that is a multiple "
                         f"of 8 up to 128 and Sq, Sk >= 1, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if bias is not None:
        _check_bias(bias, tuple(q.shape[:-2]), sq, sk)
    return _FlashAttention.apply(q, k, v, bias, scale)
