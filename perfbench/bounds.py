"""Operations and bytes of one call of a hand-kernel op, from its shapes,
and the least time the card could take for it: the larger of the bytes
over the memory's peak and the operations over the peak of their type.
Inputs are read once and outputs written once, whatever a kernel reads
again (after `scripts/profile_torch_kernels.py`'s `bound`).
"""

from __future__ import annotations

from typing import Tuple

from perfbench import peaks

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


def least_seconds(ops: float, nbytes: float, dtype: str,
                  tensor_cores: bool) -> float:
    """The larger of bytes over the memory's peak and operations over the
    peak of their type (the tensor cores' for the products of a 16-bit
    type, float32's outside them otherwise)."""
    rate = peaks.FLOPS[dtype] if tensor_cores else peaks.FLOPS["float32"]
    return max(nbytes / peaks.BYTES_PER_S, ops / rate)
