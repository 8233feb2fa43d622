"""The CUDA kernels of egovlpv2_torch against their plain PyTorch versions,
and the dispatch and checks around them.

Tests marked `gpu` need a CUDA card and skip without one. This file imports
torch and the port only (no jax), so on a machine with a card and without
jax it runs as:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops import flash
from egovlpv2_torch.ops import layernorm as ln
from egovlpv2_torch.ops.attention import (attend, attend_plain,
                                          make_additive_mask)
from egovlpv2_torch.ops.divided import (divided_attention,
                                        divided_attention_backward_reference,
                                        divided_attention_reference)

torch.set_num_threads(2)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Backward: max abs error of each of dq, dk, dv, relative to max |reference|
# of that tensor, because a gradient's scale follows the cotangent's; the
# CLS row (sequence row 0) and the patch rows are each held to their own
# maximum, because the CLS key gathers from every query and its dk/dv are
# many times a patch key's. f32:
# another summation order. bf16: the kernels keep P, dP and dS in f32 and
# round only the stores, where the plain version and its autograd round P
# and dS to bf16 before each product; K6 also rounds the dk/dv rows of
# K4/K5 a second time when it adds the CLS query's share in place.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

CASES = [
    # (B, F, N, H, Dh): slice shapes, odd group sizes, head dims that leave
    # idle lanes (24, 72), the largest head dim, one frame, one patch, and
    # query tiles and key chunks of the tensor-core space kernel that end
    # part-way (N = 70, 130).
    (2, 4, 196, 12, 64),
    (1, 16, 196, 2, 64),
    (2, 3, 5, 3, 8),
    (2, 5, 7, 2, 24),
    (1, 2, 33, 2, 72),
    (1, 4, 16, 2, 128),
    (1, 1, 9, 2, 16),
    (3, 6, 1, 1, 32),
    (1, 2, 70, 2, 48),
    (1, 3, 130, 1, 80),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, s, h, dh, dtype=torch.float32, device="cpu"):
    x = np.random.RandomState(seed).randn(b, s, 3, h, dh).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case, axis, dtype):
    b, f, n, h, dh = case
    qkv = _qkv(0, b, 1 + f * n, h, dh, dtype, cuda)
    before = dict(_kernels.launch_counts)
    got = divided_attention(qkv, scale=dh ** -0.5, axis=axis, num_frames=f)
    torch.cuda.synchronize()
    ref = divided_attention_reference(qkv, scale=dh ** -0.5, axis=axis,
                                      num_frames=f)
    assert got.shape == ref.shape and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    grouped = "space_attention_fwd" if axis == "space" else "time_attention_fwd"
    assert _kernels.launch_counts[grouped] == before[grouped] + 1
    assert (_kernels.launch_counts["cls_row_attention_fwd"]
            == before["cls_row_attention_fwd"] + 1)


def _rel_errs(got, ref):
    """Max abs error of dq, dk, dv ([B, S, 3, H, Dh] split on dim 2), on
    the CLS row and on the patch rows, each relative to max |ref| of those
    rows of that tensor: six figures."""
    return [((got[:, rows, i].float() - ref[:, rows, i].float()).abs().max()
             / ref[:, rows, i].float().abs().max().clamp_min(1e-30)).item()
            for i in range(3) for rows in (slice(0, 1), slice(1, None))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("case", CASES)
def test_backward_kernels_match_plain(cuda, case, axis, dtype):
    """The whole gradient through the autograd Function (K4 or K5, then
    K6), with a cotangent that is a non-contiguous view."""
    b, f, n, h, dh = case
    s = 1 + f * n
    qkv = _qkv(0, b, s, h, dh, dtype, cuda)
    g = _qkv(1, b, s, h, dh, dtype, cuda)[:, :, 1]  # a strided view
    assert not g.is_contiguous()
    leaf = qkv.clone().requires_grad_(True)
    before = dict(_kernels.launch_counts)
    out = divided_attention(leaf, scale=dh ** -0.5, axis=axis, num_frames=f)
    out.backward(g)
    torch.cuda.synchronize()
    ref = divided_attention_backward_reference(qkv, g, scale=dh ** -0.5,
                                               axis=axis, num_frames=f)
    assert leaf.grad.shape == ref.shape and leaf.grad.dtype == dtype
    assert torch.isfinite(leaf.grad).all()
    errs = _rel_errs(leaf.grad, ref)
    assert max(errs) <= BWD_RTOL[dtype], errs
    grouped = "space_attention_bwd" if axis == "space" else "time_attention_bwd"
    other = "time_attention_bwd" if axis == "space" else "space_attention_bwd"
    assert _kernels.launch_counts[grouped] == before[grouped] + 1
    assert _kernels.launch_counts[other] == before[other]
    assert (_kernels.launch_counts["cls_row_attention_bwd"]
            == before["cls_row_attention_bwd"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
def test_backward_kernels_one_by_one(cuda, axis, dtype):
    """K4/K5 alone against the gradient of rows 1..S-1 (the CLS key's row
    from the summed partials), and K6 alone, on a zeroed dqkv and zero
    partials, against the gradient of row 0."""
    b, f, n, h, dh = 2, 4, 50, 3, 64
    s, scale = 1 + f * n, dh ** -0.5
    qkv = _qkv(2, b, s, h, dh, dtype, cuda)
    g = _qkv(3, b, s, h, dh, dtype, cuda)[:, :, 0].contiguous()
    flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
    kw = dict(scale=scale, axis=axis, num_frames=f)
    stats, parts = _kernels.attention_bwd_scratch(flat, num_heads=h,
                                                  num_frames=f, axis=axis)
    dqkv = torch.full_like(flat, float("nan"))
    launch = (_kernels.space_attention_bwd if axis == "space"
              else _kernels.time_attention_bwd)
    launch(flat, gflat, dqkv, stats, parts, num_heads=h, num_frames=f,
           scale=scale)
    torch.cuda.synchronize()
    ref = divided_attention_backward_reference(qkv, g, rows="grouped", **kw)
    got = dqkv.view(b, s, 3, h, dh).clone()
    assert torch.isnan(got[:, 0]).all()  # row 0 is K6's
    got[:, 0, 0] = 0  # no patch row's output depends on the CLS query
    got[:, 0, 1:] = parts.sum(2).permute(0, 2, 1, 3).to(dtype)
    errs = _rel_errs(got, ref)
    assert max(errs) <= BWD_RTOL[dtype], errs

    dqkv.zero_()
    _kernels.cls_row_attention_bwd(flat, gflat, dqkv, torch.zeros_like(parts),
                                   num_heads=h, scale=scale)
    torch.cuda.synchronize()
    ref = divided_attention_backward_reference(qkv, g, rows="cls", **kw)
    errs = _rel_errs(dqkv.view(b, s, 3, h, dh), ref)
    assert max(errs) <= BWD_RTOL[dtype], errs


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    out = torch.empty(1, 5, 2 * 12, device=cuda)
    with pytest.raises(ValueError, match="head dim"):  # Dh = 12
        _kernels.space_attention_fwd(torch.zeros(1, 5, 72, device=cuda), out,
                                     num_heads=2, num_frames=2, scale=1.0)
    with pytest.raises(TypeError):
        _kernels.cls_row_attention_fwd(
            torch.zeros(1, 5, 48, device=cuda, dtype=torch.float16),
            out.half(), num_heads=2, scale=1.0)
    qkv = _qkv(1, 2, 9, 2, 8, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        divided_attention(qkv, scale=1.0, axis="space", num_frames=2)


# LayerNorm (K7, K8). y and dx are held to max |reference| of the tensor:
# 1e-5 in f32 (sums over a row in another order, rsqrt within 2 ulp), 2e-2
# in bf16 (at most one bf16 step where the f32 values differ in the last
# bits before the rounding). dscale and dbias are f32 sums over the rows in
# another order than the plain version's: 1e-3 of max |reference|.
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LN_CASES = [
    # (R, D): the model's width with many, few and one row; the narrowest
    # row; widths that leave lanes idle; one, two, four and eight warps a
    # row, the widest row; strips of several rows a block in the backward.
    (1570, 768), (240, 768), (1, 768), (7, 8), (301, 776), (33, 32),
    (65, 128), (9, 1024), (130, 1032), (5, 2048), (3, 4096), (2, 8192),
    (4500, 256),
]


def _ln_inputs(r, d, dtype, device):
    rs = np.random.RandomState(r + d)
    # an offset mean: E[x^2] - E[x]^2 then differs from a two-pass variance
    x = torch.from_numpy((rs.randn(r, d) * 0.7 + 1.5).astype(np.float32))
    g = torch.from_numpy(rs.randn(r, d).astype(np.float32))
    scale = torch.from_numpy((1 + 0.2 * rs.randn(d)).astype(np.float32))
    bias = torch.from_numpy((0.2 * rs.randn(d)).astype(np.float32))
    return (x.to(device=device, dtype=dtype), g.to(device=device, dtype=dtype),
            scale.to(device), bias.to(device))


def _ln_rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LN_CASES)
def test_layernorm_kernels_match_plain(cuda, case, dtype, eps):
    """K7 and K8 through the autograd Function against the plain forward
    and the plain backward, twice: the backward has no atomics, so its
    results repeat bit for bit."""
    r, d = case
    x, g, scale, bias = _ln_inputs(r, d, dtype, cuda)
    before = dict(_kernels.launch_counts)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        y = ln.layernorm(*leaves, eps=eps)
        y.backward(g)
        torch.cuda.synchronize()
        runs.append((y.detach(), *(t.grad for t in leaves)))
    y, dx, dscale, dbias = runs[0]
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    assert dscale.dtype == dbias.dtype == torch.float32
    ref_y = ln.layernorm_reference(x, scale, bias, eps=eps)
    ref_dx, ref_dscale, ref_dbias = ln.layernorm_backward_reference(
        x, scale, g, eps)
    assert _ln_rel(y, ref_y) <= LN_TOL[dtype]
    assert _ln_rel(dx, ref_dx) <= LN_TOL[dtype]
    assert _ln_rel(dscale, ref_dscale) <= 1e-3
    assert _ln_rel(dbias, ref_dbias) <= 1e-3
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert _kernels.launch_counts["layernorm_fwd"] == before["layernorm_fwd"] + 2
    assert _kernels.launch_counts["layernorm_bwd"] == before["layernorm_bwd"] + 2


@pytest.mark.gpu
def test_layernorm_kernels_take_views_and_leading_axes(cuda):
    """A sliced input and a strided cotangent are copied once each, and the
    gradient comes back in the input's shape."""
    x, g, scale, bias = _ln_inputs(6 * 10, 64, torch.bfloat16, cuda)
    x, g = x.view(6, 10, 64), g.view(6, 10, 64)
    leaf = x.clone().requires_grad_(True)
    ln.contiguous_copies.update(x=0, g=0)
    y = ln.layernorm(leaf[:, 0], scale, bias, eps=1e-5)
    y.backward(g.transpose(0, 1)[0])
    torch.cuda.synchronize()
    assert ln.contiguous_copies == {"x": 1, "g": 1}
    ref_dx, _, _ = ln.layernorm_backward_reference(
        x[:, 0], scale, g.transpose(0, 1)[0], 1e-5)
    assert leaf.grad.shape == x.shape
    assert not leaf.grad[:, 1:].any()
    assert _ln_rel(leaf.grad[:, 0], ref_dx) <= LN_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_layernorm_wrapper_rejects_what_it_cannot_take(cuda):
    w = torch.ones(12, device=cuda)
    with pytest.raises(ValueError, match=r"\(4, 12\)"):  # D not a multiple of 8
        ln.layernorm(torch.zeros(4, 12, device=cuda), w, w)
    wide = torch.ones(8200, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 8200\)"):
        ln.layernorm(torch.zeros(2, 8200, device=cuda), wide, wide)
    w = torch.ones(16, device=cuda)
    with pytest.raises(TypeError):
        ln.layernorm(torch.zeros(4, 16, device=cuda, dtype=torch.float16), w, w)
    with pytest.raises(ValueError, match="float32"):
        ln.layernorm(torch.zeros(4, 16, device=cuda), w.double(), w)


# Fused attention (K9) against `flash_attention_reference` on the same values
# in f32, not rounded: max abs error of max |reference|, 1e-4 in f32 (sums
# over the keys in another order, expf within 2 ulp) and 4e-3 in bf16 (both
# forms keep P in f32 as the reference does, the tensor-core form as two bf16
# terms, so what is left is the one rounding of the output: 2^-8 of the
# largest value).
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
FLASH_CASES = [
    # (B, H, Sq, Sk, Dh, layout, bias): text self-attention at 15 and 30
    # tokens; i2t (many queries, few keys, k and v slices of one packed
    # projection); t2i (few queries, keys split over a block's warps);
    # lengths above the JAX package's threshold; an odd case; one query row;
    # one key; the narrowest and the widest head dim.
    (4, 12, 15, 15, 64, "heads", "mask"),
    (2, 12, 30, 30, 64, "heads", "mask"),
    (2, 12, 785, 15, 64, "packed", "mask"),
    (2, 12, 15, 785, 64, "heads", None),
    (1, 2, 30, 3137, 64, "heads", None),
    (2, 3, 197, 197, 64, "heads", None),
    (2, 2, 64, 64, 64, "plain", "mask"),
    (2, 3, 37, 33, 40, "plain", "mask"),
    (1, 2, 1, 300, 64, "heads", "mask"),
    (2, 2, 9, 1, 16, "plain", None),
    (3, 2, 50, 70, 8, "heads", "mask"),
    (1, 2, 20, 500, 128, "heads", "masked_row"),
    (2, 2, 16, 20, 64, "heads", "masked_row"),
]


def _flash_inputs(case, dtype, device):
    """q, k, v [B, H, S, Dh] and the bias, laid out as the models give
    them: "heads" transposed views of [B, S, H*Dh] projections, "packed" k
    and v slices of one [B, Sk, 2, H, Dh] projection, "plain" contiguous."""
    b, h, sq, sk, dh, layout, bias_kind = case
    rs = np.random.RandomState(sq * 7 + sk)

    def proj(s, parts=1):
        x = torch.from_numpy(rs.randn(b, s, parts, h, dh).astype(np.float32))
        return x.to(device=device, dtype=dtype)

    q = proj(sq)[:, :, 0].transpose(1, 2)
    if layout == "packed":
        kv = proj(sk, 2).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    else:
        k, v = (proj(sk)[:, :, 0].transpose(1, 2) for _ in range(2))
    if layout == "plain":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = None
    if bias_kind is not None:
        mask = (rs.rand(b, sk) > 0.3).astype(np.int64)
        mask[:, 0] = 1
        if bias_kind == "masked_row":
            mask[0] = 0  # every key of batch 0 masked: uniform over them
        bias = make_additive_mask(torch.from_numpy(mask)).to(device)
    return q, k, v, bias


def _flash_rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_fused_attention_kernel_matches_plain(cuda, case, dtype):
    """K9 through `attend`, forward and gradients, twice: no atomics, so
    the results repeat bit for bit; no input is copied."""
    b, h, sq, sk, dh = case[:5]
    q, k, v, bias = _flash_inputs(case, dtype, cuda)
    g = torch.from_numpy(np.random.RandomState(5).randn(b, h, sq, dh).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    before = dict(_kernels.launch_counts)
    flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = attend(*leaves, scale=dh ** -0.5, bias=bias)
        out.backward(g)
        torch.cuda.synchronize()
        runs.append((out.detach(), *(t.grad for t in leaves)))
    out = attend(q, k, v, scale=dh ** -0.5, bias=bias)  # the strided views
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_attention_fwd"] \
        == before["fused_attention_fwd"] + 3
    assert flash.contiguous_copies == {"q": 0, "k": 0, "v": 0, "bias": 0}
    assert out.shape == (b, h, sq, dh) and out.dtype == dtype
    assert out.transpose(1, 2).reshape(b, sq, h * dh).data_ptr() == out.data_ptr()
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float(),
                                          scale=dh ** -0.5, bias=bias)
    assert torch.isfinite(out).all()
    assert _flash_rel(out, ref) <= FLASH_TOL[dtype]
    assert _flash_rel(runs[0][0], ref) <= FLASH_TOL[dtype]
    if case[6] == "masked_row":
        uniform = v[0].float().mean(dim=-2, keepdim=True).expand(h, sq, dh)
        assert _flash_rel(out[0], uniform) <= FLASH_TOL[dtype]
    # gradients against autograd through the plain version
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash.flash_attention_reference(*leaves, scale=dh ** -0.5,
                                    bias=bias).backward(g)
    for got, leaf in zip(runs[0][1:], leaves):
        assert got.shape == leaf.shape and got.dtype == dtype
        assert _flash_rel(got, leaf.grad) <= BWD_RTOL[dtype]
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_fused_attention_takes_leading_axes_and_counts_copies(cuda):
    """Any number of leading axes; an input the kernel cannot read by
    stride is copied and counted."""
    rs = np.random.RandomState(6)
    q = torch.from_numpy(rs.randn(2, 3, 2, 37, 40).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rs.randn(2, 3, 2, 33, 40).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rs.randn(2, 3, 2, 33, 40).astype(np.float32)).to(cuda)
    flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)
    for lead in (5, 3, 2):
        qq, kk, vv = (t[(0,) * (5 - lead)] for t in (q, k, v))
        got = flash.flash_attention(qq, kk, vv, scale=0.2)
        ref = flash.flash_attention_reference(qq, kk, vv, scale=0.2)
        assert got.shape == ref.shape
        assert _flash_rel(got, ref) <= TOL[torch.float32]
    assert flash.contiguous_copies == {"q": 0, "k": 0, "v": 0, "bias": 0}
    kt = k.transpose(-1, -2).contiguous().transpose(-1, -2)  # Dh strided
    got = flash.flash_attention(q, kt, v, scale=0.2,
                                bias=torch.zeros(1, 33, device=cuda,
                                                 dtype=torch.float64))
    assert _flash_rel(got, flash.flash_attention_reference(
        q, k, v, scale=0.2)) <= TOL[torch.float32]
    assert flash.contiguous_copies == {"q": 0, "k": 1, "v": 0, "bias": 1}


@pytest.mark.gpu
def test_attend_with_dropout_keeps_the_plain_path_on_the_card(cuda):
    q, k, v, bias = _flash_inputs(FLASH_CASES[0], torch.bfloat16, cuda)
    before = dict(_kernels.launch_counts)
    gen = torch.Generator(device=cuda).manual_seed(0)
    out = attend(q, k, v, scale=0.125, bias=bias, prob_dropout=0.1,
                 generator=gen)
    assert out.shape == q.shape and _kernels.launch_counts == before
    attend(q, k, v, scale=0.125, bias=bias)
    assert _kernels.launch_counts["fused_attention_fwd"] \
        == before["fused_attention_fwd"] + 1
    # the plain code agrees with the kernel but for its rounding of P
    assert _flash_rel(attend_plain(q, k, v, scale=0.125, bias=bias),
                      attend(q, k, v, scale=0.125, bias=bias)) <= 2e-2


def test_layernorm_cpu_tensor_takes_the_plain_versions():
    """The Function's CPU route: the plain forward, and the written-out
    backward within 1e-6 of autograd through the plain forward (f32, the
    same formulas in another order); no kernel is launched."""
    x, g, scale, bias = _ln_inputs(21, 40, torch.float32, "cpu")
    x, g = x.view(3, 7, 40), g.view(3, 7, 40)
    before = dict(_kernels.launch_counts)
    grads = []
    for fn in (ln.layernorm, ln.layernorm_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        y = fn(*leaves, eps=1e-6)
        y.backward(g)
        grads.append((y.detach(), *(t.grad for t in leaves)))
    assert torch.equal(grads[0][0], grads[1][0])
    for got, ref in zip(grads[0][1:], grads[1][1:]):
        assert got.shape == ref.shape
        assert _ln_rel(got, ref) <= 1e-6
    assert _kernels.launch_counts == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ln.layernorm(torch.empty(2, 8, device="meta"), scale[:8], bias[:8])


def test_cpu_tensor_takes_the_plain_version():
    qkv = _qkv(2, 2, 1 + 3 * 4, 2, 8)
    before = dict(_kernels.launch_counts)
    for axis in ("space", "time"):
        got = divided_attention(qkv, scale=0.3, axis=axis, num_frames=3)
        ref = divided_attention_reference(qkv, scale=0.3, axis=axis,
                                          num_frames=3)
        assert torch.equal(got, ref)
    assert _kernels.launch_counts == before


def test_other_devices_and_axes_raise():
    with pytest.raises(ValueError, match="cpu or cuda"):
        divided_attention(torch.empty(1, 5, 3, 2, 8, device="meta"),
                          scale=1.0, axis="space", num_frames=2)
    with pytest.raises(ValueError, match="axis"):
        divided_attention(_qkv(3, 1, 5, 2, 8), scale=1.0, axis="depth",
                          num_frames=2)


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    qkv, out = torch.zeros(1, 5, 48), torch.zeros(1, 5, 16)
    for launch in (_kernels.space_attention_fwd, _kernels.time_attention_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            launch(qkv, out, num_heads=2, num_frames=2, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.cls_row_attention_fwd(qkv, out, num_heads=2, scale=1.0)
    dq = torch.zeros_like(qkv)
    stats, parts = torch.zeros(2, 1, 2, 5), torch.zeros(1, 2, 1, 2, 8)
    for launch in (_kernels.space_attention_bwd, _kernels.time_attention_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            launch(qkv, out, dq, stats, parts, num_heads=2, num_frames=2,
                   scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.cls_row_attention_bwd(qkv, out, dq, parts, num_heads=2,
                                       scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.attention_bwd_scratch(qkv, num_heads=2, num_frames=2,
                                       axis="space")
    libs = _kernels.library_paths()
    x, w = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.layernorm_fwd(x, w, w, torch.empty_like(x), eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.layernorm_bwd(x, w, x, torch.empty_like(x), w.clone(),
                               w.clone(), torch.zeros(1, 2, 16), eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.layernorm_bwd_scratch(x)
    q4 = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.fused_attention_fwd(q4, q4, q4, None, torch.empty_like(q4),
                                     scale=1.0)
    assert set(libs) == {"divided_attention.cu", "divided_attention_bwd.cu",
                         "layernorm.cu", "fused_attention.cu"}
    for lib in libs.values():
        assert lib.parent == _kernels.BUILD_DIR
        assert lib.parent.parts[-2:] == ("build", "egovlpv2_torch")


def test_reference_row_semantics():
    """Spot-check the plain version against the definition, one row per
    axis: CLS over all keys; a space row over its frame + CLS; a time row
    over its patch column + CLS."""
    b, f, n, h, dh = 1, 3, 4, 1, 8
    s = 1 + f * n
    qkv = _qkv(4, b, s, h, dh).double()
    q, k, v = qkv[0, :, 0, 0], qkv[0, :, 1, 0], qkv[0, :, 2, 0]

    def row(r, keys):
        w = torch.softmax(k[keys] @ q[r] * 0.5, dim=0)
        return w @ v[keys]

    space = divided_attention_reference(qkv, scale=0.5, axis="space",
                                        num_frames=f)[0, :, 0]
    time_ = divided_attention_reference(qkv, scale=0.5, axis="time",
                                        num_frames=f)[0, :, 0]
    r = 1 + 1 * n + 2  # frame 1, patch 2
    torch.testing.assert_close(space[0], row(0, list(range(s))))
    torch.testing.assert_close(time_[0], row(0, list(range(s))))
    torch.testing.assert_close(space[r], row(r, [0] + list(range(1 + n, 1 + 2 * n))))
    torch.testing.assert_close(time_[r], row(r, [0] + [1 + g * n + 2 for g in range(f)]))


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's scripts
    import in a fresh interpreter without jax, flax, optax or the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import egovlpv2_torch\n"
        "for m in pkgutil.walk_packages(egovlpv2_torch.__path__, 'egovlpv2_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import profile_torch_egomcq, profile_torch_pretrain\n"
        "import profile_torch_finetune, profile_torch_extract\n"
        "import profile_torch_flash\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'egovlpv2_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('egovlpv2_torch')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 35
