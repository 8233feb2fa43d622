"""Divided space-time attention with the CLS splice (port of
`egovlpv2_tpu/ops/divided.py`).

Semantics of the reference `EgoVLPv2/model/video_transformer.py:117-153`,
as `_divided_xla` states them: the CLS query attends the whole sequence;
a patch query attends the patches of its own frame (space axis) or of its
own patch column across frames (time axis), plus the CLS key.

`divided_attention` dispatches on the device of its input:
  * a CPU tensor takes the plain PyTorch version,
    `divided_attention_reference`, and autograd differentiates it;
  * a CUDA tensor takes the hand-written kernels of `csrc/`, forward
    (K1 space or K2 time for rows 1..S-1, K3 for the CLS row) and
    backward (K4 space or K5 time, then K6 for the CLS row), which read
    q, k and v by stride from the qkv Linear output and write dqkv in the
    same layout; a kernel that cannot build or launch raises;
  * any other device raises.

`divided_attention_backward_reference` is the plain version of the
backward: autograd through `divided_attention_reference`. The tests and
`chip_smoke.py` hold K4-K6 against it; nothing on the card's path calls it.
"""

from __future__ import annotations

import torch

from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops.attention import attend_plain

_AXES = ("space", "time")


def cls_row_reference(qkv: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Row 0 of the output: the CLS query over all S keys. [B, 1, H, Dh]."""
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, S, Dh] each
    return attend_plain(q[:, :, :1], k, v, scale=scale).transpose(1, 2)


def grouped_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                      num_frames: int) -> torch.Tensor:
    """Rows 1..S-1 of the output: each patch query over its frame (space)
    or its patch column (time) plus the CLS key. [B, S-1, H, Dh]."""
    if axis not in _AXES:
        raise ValueError(f"axis must be one of {_AXES}, got {axis!r}")
    b, s, _, h, dh = qkv.shape
    f = num_frames
    n = (s - 1) // f
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def grouped(t):
        t = t[:, :, 1:].reshape(b, h, f, n, dh)
        return t.transpose(2, 3) if axis == "time" else t

    qg, kg, vg = grouped(q), grouped(k), grouped(v)
    g = qg.shape[2]
    kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, dh), kg], dim=3)
    vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, dh), vg], dim=3)
    out = attend_plain(qg, kg, vg, scale=scale)
    if axis == "time":
        out = out.transpose(2, 3)
    return out.reshape(b, h, f * n, dh).transpose(1, 2)


def divided_attention_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                                num_frames: int) -> torch.Tensor:
    """Plain PyTorch divided attention: qkv [B, S, 3, H, Dh] -> [B, S, H, Dh]."""
    return torch.cat([
        cls_row_reference(qkv, scale=scale),
        grouped_reference(qkv, scale=scale, axis=axis, num_frames=num_frames),
    ], dim=1)


def divided_attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                        *, scale: float, axis: str,
                                        num_frames: int,
                                        rows: str = "all") -> torch.Tensor:
    """Plain PyTorch backward: the gradient of sum(out * g) w.r.t. qkv.

    qkv [B, S, 3, H, Dh], g [B, S, H, Dh] -> dqkv [B, S, 3, H, Dh] in
    qkv.dtype. `rows` picks the part of the output that is differentiated:
    "all", "grouped" (rows 1..S-1, what K4/K5 compute) or "cls" (row 0,
    what K6 computes); g keeps its full shape either way."""
    leaf = qkv.detach().requires_grad_(True)
    with torch.enable_grad():
        if rows == "all":
            out = divided_attention_reference(leaf, scale=scale, axis=axis,
                                              num_frames=num_frames)
        elif rows == "grouped":
            out, g = grouped_reference(leaf, scale=scale, axis=axis,
                                       num_frames=num_frames), g[:, 1:]
        elif rows == "cls":
            out, g = cls_row_reference(leaf, scale=scale), g[:, :1]
        else:
            raise ValueError(f"rows must be all, grouped or cls, got {rows!r}")
        (dqkv,) = torch.autograd.grad(out, leaf, g)
    return dqkv


class _DividedAttentionKernels(torch.autograd.Function):
    """The CUDA kernels as one differentiable function of the flat qkv
    [B, S, 3*H*Dh] -> [B, S, H*Dh]. Only qkv is saved: the backward kernels
    recompute the softmax from it."""

    @staticmethod
    def forward(ctx, flat, num_heads, num_frames, scale, axis):
        b, s, w3 = flat.shape
        out = torch.empty((b, s, w3 // 3), dtype=flat.dtype,
                          device=flat.device)
        grouped_fwd = (_kernels.space_attention_fwd if axis == "space"
                       else _kernels.time_attention_fwd)
        grouped_fwd(flat, out, num_heads=num_heads, num_frames=num_frames,
                    scale=scale)
        _kernels.cls_row_attention_fwd(flat, out, num_heads=num_heads,
                                       scale=scale)
        ctx.save_for_backward(flat)
        ctx.attrs = (num_heads, num_frames, scale, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        num_heads, num_frames, scale, axis = ctx.attrs
        # Autograd may hand over a view (of the proj Linear's input grad);
        # the kernels read rows by one stride, so it is copied then.
        g = g.contiguous()
        dqkv = torch.empty_like(flat)
        stats, cls_part = _kernels.attention_bwd_scratch(
            flat, num_heads=num_heads, num_frames=num_frames, axis=axis)
        grouped_bwd = (_kernels.space_attention_bwd if axis == "space"
                       else _kernels.time_attention_bwd)
        grouped_bwd(flat, g, dqkv, stats, cls_part, num_heads=num_heads,
                    num_frames=num_frames, scale=scale)
        _kernels.cls_row_attention_bwd(flat, g, dqkv, cls_part,
                                       num_heads=num_heads, scale=scale)
        return dqkv, None, None, None, None


def divided_attention(qkv: torch.Tensor, *, scale: float, axis: str,
                      num_frames: int) -> torch.Tensor:
    """Divided space/time self-attention with the CLS splice.

    qkv: [B, S, 3, H, Dh], the reshape of the qkv Linear output, with
    S = 1 + num_frames * N. Returns [B, S, H, Dh] in qkv.dtype.
    """
    if axis not in _AXES:
        raise ValueError(f"axis must be one of {_AXES}, got {axis!r}")
    if qkv.device.type == "cpu":
        return divided_attention_reference(qkv, scale=scale, axis=axis,
                                           num_frames=num_frames)
    if qkv.device.type != "cuda":
        raise ValueError(f"divided_attention runs on cpu or cuda, not "
                         f"{qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("divided_attention needs a contiguous qkv")
    b, s, _, h, dh = qkv.shape
    out = _DividedAttentionKernels.apply(qkv.view(b, s, 3 * h * dh), h,
                                         num_frames, scale, axis)
    return out.view(b, s, h, dh)
