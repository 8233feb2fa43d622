"""The copied bound arithmetic against its source's numbers at one shape:
`scripts/profile_torch_kernels.py`'s `bound` for K1 (space forward) at
B=16, 4 frames, H=12, Dh=64, bf16, which reads 0.0230 ms by bytes, and
its LayerNorm bounds."""

import pytest

from perfbench import bounds, peaks

B, F, N, H, DH = 16, 4, 196, 12, 64
S = 1 + F * N


def test_divided_forward_is_k1_and_the_cls_row():
    ops, nbytes = bounds.divided_attention(B, S, H, DH, F, "space",
                                           "bfloat16", backward=False)
    # the source's K1: q's patch rows, k and v read, s - 1 rows written
    k1_bytes = (4 * S - 2) * B * H * DH * 2
    k1_ops = 2 * 2 * B * H * (S - 1) * (N + 1) * DH
    cls_ops = 2 * 2 * B * H * S * DH
    assert nbytes == k1_bytes + 2 * B * H * DH * 2
    assert ops == k1_ops + cls_ops
    least = bounds.least_seconds(ops, nbytes, "bfloat16", True)
    assert least == nbytes / peaks.BYTES_PER_S  # bound by bytes
    assert k1_bytes / 3.35e12 * 1e3 == pytest.approx(0.0230, abs=5e-5)


def test_divided_time_axis_counts_columns():
    ops, _ = bounds.divided_attention(B, S, H, DH, F, "time", "bfloat16",
                                      backward=False)
    assert ops == 4 * B * H * DH * ((S - 1) * (F + 1) + S)
    bwd_ops, bwd_bytes = bounds.divided_attention(B, S, H, DH, F, "time",
                                                  "bfloat16", backward=True)
    assert bwd_ops == ops * 5 // 2
    assert bwd_bytes == 8 * B * S * H * DH * 2


@pytest.mark.parametrize("rows,d,dtype,e", [(12560, 768, "bfloat16", 2),
                                            (8192, 128, "float32", 4)])
def test_layernorm_bytes_are_the_sources(rows, d, dtype, e):
    _, fwd = bounds.layernorm(rows, d, dtype, backward=False)
    _, bwd = bounds.layernorm(rows, d, dtype, backward=True)
    assert fwd == 2 * rows * d * e + 2 * d * 4
    assert bwd == 3 * rows * d * e + 3 * d * 4
    ops, _ = bounds.layernorm(rows, d, dtype, backward=False)
    assert bounds.least_seconds(ops, fwd, dtype, False) \
        == fwd / peaks.BYTES_PER_S


def test_peaks_are_the_data_sheets():
    assert peaks.FLOPS["bfloat16"] == 989e12
    assert peaks.BYTES_PER_S == 3.35e12


def test_fused_attention_reads_each_input_once():
    """K9's i2t at the pretrain cell's shapes (B=64, H=12, S=785 queries
    over 15 text keys, Dh=64, bf16): bound by bytes."""
    b, h, sq, sk, dh = 64, 12, 785, 15, 64
    ops, nbytes = bounds.fused_attention(b, h, sq, sk, dh, "bfloat16",
                                         causal=False, bias=True)
    assert ops == 4 * b * h * sq * sk * dh
    assert nbytes == (2 * sq + 2 * sk) * b * h * dh * 2 + b * sk * 4
    least = bounds.least_seconds(ops, nbytes, "bfloat16", True)
    assert least == nbytes / peaks.BYTES_PER_S
    assert least * 1e3 == pytest.approx(0.04695, abs=5e-5)
    _, no_bias = bounds.fused_attention(b, h, sq, sk, dh, "bfloat16",
                                        causal=False, bias=False)
    assert nbytes - no_bias == b * sk * 4


@pytest.mark.parametrize("sq,sk,pairs", [(4, 4, 10), (2, 4, 7), (4, 2, 3),
                                         (77, 77, 77 * 78 // 2)])
def test_causal_counts_the_visible_pairs(sq, sk, pairs):
    ops, _ = bounds.fused_attention(1, 1, sq, sk, 64, "bfloat16",
                                    causal=True, bias=False)
    assert ops == 4 * pairs * 64


def test_a_fused_call_counts_its_forward_alone():
    shape = (("b", 2), ("h", 2), ("sq", 9), ("sk", 5), ("dh", 16),
             ("dtype", "bfloat16"), ("causal", False), ("bias", True))
    fwd = bounds.least_seconds(*bounds.fused_attention(**dict(shape)),
                               "bfloat16", True)
    for backward in (False, True):
        assert bounds.call_seconds(bounds.Call("fused_attn", shape,
                                               backward)) == fwd
