"""Operations and bytes of one call of a hand-kernel op, from its shapes,
and the least time the card could take for it: the larger of the bytes
over the memory's peak and the operations over the peak of their type.
Inputs are read once and outputs written once, whatever a kernel reads
again (after `scripts/profile_torch_kernels.py`'s `bound`).

The step's calls of the ops (`pretrain_calls`, `dual_calls`: the divided
attention, LayerNorm and the fused attention K9) are counted
from a configuration's shapes and the paths the step takes, as
`perfbench/flops.py` counts its operations: each call with its shape and
whether its output reaches a loss, so that its backward runs. They follow
the port's modules at remat off, the cells' setting; a recomputed forward
is not counted.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from perfbench import flops, kinds, peaks

ELEMENT = {"bfloat16": 2, "float16": 2, "float32": 4}


def divided_attention(b: int, s: int, h: int, dh: int, frames: int,
                      axis: str, dtype: str,
                      backward: bool) -> Tuple[float, float]:
    """(operations, bytes) of one divided attention over qkv [B, S, 3, H,
    Dh]: every patch query over its frame (space) or patch column (time)
    and the CLS key, the CLS query over all S keys. Forward: two products a
    (query, key) pair; q, k, v read and the output written. Backward: five
    products a pair (the logits again, dP, dS's two, dV); q, k, v, the
    output and its gradient read, dq, dk and dv written."""
    n = (s - 1) // frames
    keys = (n if axis == "space" else frames) + 1
    pairs = (s - 1) * keys + s
    e = ELEMENT[dtype]
    row = b * s * h * dh * e
    if backward:
        return 5 * 2 * b * h * pairs * dh, 8 * row
    return 2 * 2 * b * h * pairs * dh, 4 * row


def layernorm(rows: int, d: int, dtype: str,
              backward: bool) -> Tuple[float, float]:
    """(operations, bytes) of one LayerNorm over [rows, d] with float32
    scale and bias. Forward: x read, y written (about 8 operations an
    element: the two sums, the normalisation, the affine). Backward: x and
    the gradient read, dx written, the scale read and its and the bias's
    gradients written (about 11 operations an element)."""
    e = ELEMENT[dtype]
    if backward:
        return 11 * rows * d, 3 * rows * d * e + 3 * d * 4
    return 8 * rows * d, 2 * rows * d * e + 2 * d * 4


def fused_attention(b: int, h: int, sq: int, sk: int, dh: int, dtype: str,
                    causal: bool, bias: bool) -> Tuple[float, float]:
    """(operations, bytes) of one forward of the fused attention (K9) over
    q [B, H, Sq, Dh] and k, v [B, H, Sk, Dh]: two products a (query, key)
    pair, each query over all keys or, `causal`, over the keys up to its
    own position (the last query row against the last key); q, k, v and
    the float32 bias [B, 1, 1, Sk], where there is one, read once and the
    output written once. Its backward is plain PyTorch, not K9."""
    if causal:
        pairs = sum(min(max(i + 1 + sk - sq, 0), sk) for i in range(sq))
    else:
        pairs = sq * sk
    e = ELEMENT[dtype]
    nbytes = b * h * (2 * sq + 2 * sk) * dh * e + (b * sk * 4 if bias else 0)
    return 2 * 2 * b * h * pairs * dh, nbytes


def least_seconds(ops: float, nbytes: float, dtype: str,
                  tensor_cores: bool) -> float:
    """The larger of bytes over the memory's peak and operations over the
    peak of their type (the tensor cores' for the products of a 16-bit
    type, float32's outside them otherwise)."""
    rate = peaks.FLOPS[dtype] if tensor_cores else peaks.FLOPS["float32"]
    return max(nbytes / peaks.BYTES_PER_S, ops / rate)


class Call(NamedTuple):
    """One call of a hand-kernel op: `op` ("divided_attn", "layernorm" or
    "fused_attn"), its shape as (field, value) pairs in the order of the
    benchmark's ranges (`trace.call_name`), and whether its output reaches
    a loss, so that its backward runs."""
    op: str
    shape: Tuple[Tuple[str, object], ...]
    backward: bool


def call_seconds(call: Call) -> float:
    """The least time of the hand kernels of one call: forward and, where
    it takes one, backward, but the fused attention's forward alone (its
    backward is no hand kernel); the attentions' products on the tensor
    cores in a 16-bit type, LayerNorm's operations outside them."""
    f = dict(call.shape)
    tensor = call.op != "layernorm" and f["dtype"] != "float32"
    if call.op == "fused_attn":
        return least_seconds(*fused_attention(**f), f["dtype"], tensor)
    count = {"divided_attn": divided_attention, "layernorm": layernorm}[
        call.op]
    passes = (False, True) if call.backward else (False,)
    return sum(least_seconds(*count(**f, backward=b), f["dtype"], tensor)
               for b in passes)


def least_seconds_of(calls: List[Call], op: str) -> float:
    return sum(call_seconds(c) for c in calls if c.op == op)


def roofline_share(ctx, op: str) -> Optional[float]:
    """The least time of the step's calls of `op` (`ctx.calls`) times the
    profiled steps, over the device time of the op's kernel family
    (`kinds.FAMILIES[op]`) in the device-only stretch, as a share; None
    where the stretch holds none of the family's kernels."""
    if ctx.timeline is None:
        return None
    device = kinds.family_seconds(ctx.timeline, op)
    least = least_seconds_of(ctx.calls, op) * ctx.stretch_steps
    if device is None or least <= 0:
        return None
    return 100.0 * least / device


def _attention(z: flops.Shapes, dtype: str, axis: str,
               backward: bool) -> Call:
    return Call("divided_attn", (("b", z.b), ("s", z.s), ("h", z.hv),
                                 ("dh", z.d // z.hv), ("frames", z.f),
                                 ("axis", axis), ("dtype", dtype)), backward)


def _layernorm(rows: int, d: int, dtype: str, backward: bool) -> Call:
    return Call("layernorm", (("rows", rows), ("d", d), ("dtype", dtype)),
                backward)


def _fused(b: int, h: int, sq: int, sk: int, d: int, dtype: str, bias: bool,
           backward: bool) -> Call:
    return Call("fused_attn", (("b", b), ("h", h), ("sq", sq), ("sk", sk),
                               ("dh", d // h), ("dtype", dtype),
                               ("causal", False), ("bias", bias)), backward)


def video_block(z: flops.Shapes, dtype: str, fused: bool,
                backward: bool) -> List[Call]:
    """`models/video.py::SpaceTimeBlock`: norm3, the time attention, norm1,
    the space attention (where text is fused in, then the i2t's norm and
    its attention over the text tokens, K9 with the text's padding bias),
    norm2."""
    ln = _layernorm(z.b * z.s, z.d, dtype, backward)
    calls = [ln, _attention(z, dtype, "time", backward), ln,
             _attention(z, dtype, "space", backward)]
    if fused:
        calls += [ln, _fused(z.b, z.hv, z.s, z.l, z.d, dtype, True,
                             backward)]
    return calls + [ln]


def text_layers(z: flops.Shapes, dtype: str, layers: int, embed: bool,
                k9: bool, fused: bool = False) -> List[Call]:
    """`models/text.py`: the embeddings' LayerNorm where `embed`, then a
    layer's: where its attention takes no probability dropout (`k9`:
    `attn_dropout` 0), K9 for its self-attention with the padding bias and,
    in a `fused` layer, for its t2i attention over the video tokens; and
    two LayerNorms (after the attention, after the feed-forward). Each
    reaches a loss on every path."""
    ln = _layernorm(z.b * z.l, z.dt, dtype, True)
    out = [ln] * int(embed)
    for _ in range(layers):
        if k9:
            out.append(_fused(z.b, z.ht, z.l, z.l, z.dt, dtype, True, True))
            if fused:
                out.append(_fused(z.b, z.ht, z.l, z.s, z.dt, dtype, False,
                                  True))
        out += [ln, ln]
    return out


def text_k9(cfg: dict) -> bool:
    """Whether a training step's text attention runs K9: only without
    probability dropout (`ops/attention.py::attend`)."""
    return cfg["model"]["text"]["attn_dropout"] == 0


def video_tower(z: flops.Shapes, dtype: str) -> List[Call]:
    """The dual video tower: every block unfused, then the final norm."""
    out = []
    for _ in range(z.depth):
        out += video_block(z, dtype, False, True)
    return out + [_layernorm(z.b * z.s, z.d, dtype, True)]


def fused_path(z: flops.Shapes, dtype: str, path: str,
               k9: bool) -> List[Call]:
    """One fused path after the shared unfused video pass
    (`models/egovlp.py::fuse_from_unfused`): the text's embeddings and
    unfused layers, then a fused video block and a fused text layer a
    depth, the fused stack's final norm, and MLM's head. On the MLM path
    the last fused video block and the final norm reach no loss (MLM reads
    the text alone, which attends the video from before that block)."""
    out = text_layers(z, dtype, z.layers - z.fuse, True, k9)
    mlm = path == "MLM"
    for i in range(z.fuse):
        out += video_block(z, dtype, True, not (mlm and i == z.fuse - 1))
        out += text_layers(z, dtype, 1, False, k9, fused=True)
    out.append(_layernorm(z.b * z.s, z.d, dtype, not mlm))
    if mlm:
        out.append(_layernorm(z.b * z.l, z.hs, dtype, True))
    return out


def pretrain_calls(cfg: dict, rows: int) -> List[Call]:
    """A pre-training step (`train/step.py::pretrain_loss_fn`): EgoNCE's
    two towers, the one unfused video pass the fused paths share, and the
    fused stacks of MLM and ITM (ITM on as many mined rows)."""
    z = flops.Shapes(cfg, rows)
    dtype, k9 = cfg["model"]["compute_dtype"], text_k9(cfg)
    out = text_layers(z, dtype, z.layers, True, k9) + video_tower(z, dtype)
    paths = [p for p in ("MLM", "ITM") if p in cfg["tasks"]]
    if paths:
        for _ in range(z.depth - z.fuse):
            out += video_block(z, dtype, False, True)
    for p in paths:
        out += fused_path(z, dtype, p, k9)
    return out


def dual_calls(cfg: dict, rows: int) -> List[Call]:
    """A dual-encoder fine-tune step: the two towers."""
    z = flops.Shapes(cfg, rows)
    dtype = cfg["model"]["compute_dtype"]
    return text_layers(z, dtype, z.layers, True, text_k9(cfg)) \
        + video_tower(z, dtype)
