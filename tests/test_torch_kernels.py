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
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops import flash
from egovlpv2_torch.ops import layernorm as ln
from egovlpv2_torch.ops.attention import (attend, attend_plain,
                                          make_additive_mask)
from egovlpv2_torch.ops.divided import (cls_row_reference,
                                        divided_attention,
                                        divided_attention_backward_reference,
                                        divided_attention_reference,
                                        grouped_kernels_take,
                                        grouped_reference,
                                        row_lse_reference,
                                        space_frame_grad_reference,
                                        space_frame_reference)

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
    # K5's tensor-core form (bf16 time, Dh a multiple of 16 up to 64,
    # F <= 63): the fine-tune's F=32, F=63 (the last on it: four 16-row
    # tiles of queries and of keys) and F=64 (the first off it), Dh=16 and
    # Dh=48 with two and three query tiles.
    (1, 32, 196, 2, 64),
    (1, 63, 3, 2, 64),
    (1, 64, 2, 2, 64),
    (1, 20, 6, 2, 16),
    (1, 40, 5, 2, 48),
    # K1's and K4's frame forms (bf16 space, a frame's N + 1 keys in at most
    # 13 16-row tiles): N = 207 (the last frame on them: 13 key and query
    # tiles), N = 208 (the first off: the grouped forms), one frame at the
    # widest head dim K1's frame form takes (K4 takes Dh <= 64), and an odd
    # frame at Dh = 16.
    (1, 2, 207, 2, 64),
    (1, 2, 208, 2, 32),
    (1, 1, 197, 2, 128),
    (2, 3, 33, 2, 16),
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
    # bf16 takes K1/K2 + K3, float32 the general kernel K10
    launched = {k for k, v in _kernels.launch_counts.items() if v != before[k]}
    grouped = "space_attention_fwd" if axis == "space" else "time_attention_fwd"
    assert launched == ({grouped, "cls_row_attention_fwd"}
                        if dtype == torch.bfloat16
                        else {"divided_attention_general_fwd"})
    assert all(_kernels.launch_counts[k] == before[k] + 1 for k in launched)


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
    """The whole gradient through the autograd Function (bf16: K4 or K5,
    then K6; float32: K11), with a cotangent that is a non-contiguous
    view."""
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
    launched = {k for k, v in _kernels.launch_counts.items()
                if v != before[k] and k.endswith("_bwd")}
    grouped = "space_attention_bwd" if axis == "space" else "time_attention_bwd"
    assert launched == ({grouped, "cls_row_attention_bwd"}
                        if dtype == torch.bfloat16
                        else {"divided_attention_general_bwd"})
    assert all(_kernels.launch_counts[k] == before[k] + 1 for k in launched)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
def test_backward_kernels_one_by_one(cuda, axis, dtype):
    """K4/K5 alone against the gradient of rows 1..S-1 (the CLS key's row
    from the summed partials), and K6 alone, from K3's output and lse0 (as
    the autograd Function runs it), on a zeroed dqkv and zero partials,
    against the gradient of row 0."""
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

    out, lse0 = _cls_row_forward(flat, h, scale)
    d_cls = torch.zeros_like(flat)
    _kernels.cls_row_attention_bwd(flat, gflat, out, lse0, d_cls,
                                   torch.zeros_like(parts), num_heads=h,
                                   scale=scale)
    torch.cuda.synchronize()
    ref = divided_attention_backward_reference(qkv, g, rows="cls", **kw)
    errs = _rel_errs(d_cls.view(b, s, 3, h, dh), ref)
    assert max(errs) <= BWD_RTOL[dtype], errs

    # K6 after K4/K5 on the rows they wrote, fed their `cls_part` (one row
    # a frame from K4's frame form): the whole gradient.
    _kernels.cls_row_attention_bwd(flat, gflat, out, lse0, dqkv, parts,
                                   num_heads=h, scale=scale)
    torch.cuda.synchronize()
    ref = divided_attention_backward_reference(qkv, g, **kw)
    errs = _rel_errs(dqkv.view(b, s, 3, h, dh), ref)
    assert max(errs) <= BWD_RTOL[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [4, 16, 32])
def test_time_bwd_kernel_alone(cuda, frames):
    """K5 alone at the paths' frame counts (bf16, Dh=64): against the
    gradient of rows 1..S-1 (the CLS key's row from the summed partials),
    sequence row 0 left alone, two runs on one input the same bits (dqkv
    and `cls_part`), and in the profiler's kernel names the one launch of
    the tensor-core form that `time_bwd_geometry` names."""
    b, n, h, dh = 2, 30, 3, 64
    s, scale = 1 + frames * n, dh ** -0.5
    qkv = _qkv(7, b, s, h, dh, torch.bfloat16, cuda)
    g = _qkv(8, b, s, h, dh, torch.bfloat16, cuda)[:, :, 0].contiguous()
    flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
    assert _kernels.time_bwd_geometry(torch.bfloat16, dh, s,
                                      frames).form == "tensor_cores"
    runs = []
    for _ in range(2):
        stats, parts = _kernels.attention_bwd_scratch(
            flat, num_heads=h, num_frames=frames, axis="time")
        dqkv = torch.full_like(flat, float("nan"))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _kernels.time_attention_bwd(flat, gflat, dqkv, stats, parts,
                                        num_heads=h, num_frames=frames,
                                        scale=scale)
            torch.cuda.synchronize()
        runs.append((dqkv, parts))
    names = [e.key for e in prof.key_averages() if e.self_device_time_total]
    assert len(names) == 1 and "time_bwd_kernel" in names[0], names
    (dqkv, parts), (dqkv2, parts2) = runs
    assert _same_bits(dqkv, dqkv2) and _same_bits(parts, parts2)
    got = dqkv.view(b, s, 3, h, dh).clone()
    assert torch.isnan(got[:, 0]).all()  # row 0 is K6's
    got[:, 0, 0] = 0
    got[:, 0, 1:] = parts.sum(2).permute(0, 2, 1, 3).to(torch.bfloat16)
    ref = divided_attention_backward_reference(
        qkv, g, scale=scale, axis="time", num_frames=frames, rows="grouped")
    errs = _rel_errs(got, ref)
    assert max(errs) <= BWD_RTOL[torch.bfloat16], errs


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [1, 4, 16, 32])
def test_space_bwd_kernel_alone(cuda, frames):
    """K4 alone at the paths' frame size (N = 196, bf16, Dh=64): the frame
    form `space_bwd_geometry` names, against the gradient of rows 1..S-1
    (the CLS key's row from the summed partials), `cls_part` one row a
    frame (parts = F), sequence row 0 left alone, two runs on one input the
    same bits (dqkv and `cls_part`), and in the profiler's kernel names the
    one launch of the frame form."""
    b, n, h, dh = 2, 196, 3, 64
    s, scale = 1 + frames * n, dh ** -0.5
    qkv = _qkv(12, b, s, h, dh, torch.bfloat16, cuda)
    g = _qkv(13, b, s, h, dh, torch.bfloat16, cuda)[:, :, 0].contiguous()
    flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
    geo = _kernels.space_bwd_geometry(torch.bfloat16, dh, s, frames)
    assert (geo.form, geo.parts) == ("frame", frames)
    runs = []
    for _ in range(2):
        stats, parts = _kernels.attention_bwd_scratch(
            flat, num_heads=h, num_frames=frames, axis="space")
        assert parts.shape == (b, h, frames, 2, dh)
        dqkv = torch.full_like(flat, float("nan"))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _kernels.space_attention_bwd(flat, gflat, dqkv, stats, parts,
                                         num_heads=h, num_frames=frames,
                                         scale=scale)
            torch.cuda.synchronize()
        runs.append((dqkv, parts))
    names = [e.key for e in prof.key_averages() if e.self_device_time_total]
    assert len(names) == 1 and "space_bwd_frame_kernel" in names[0], names
    (dqkv, parts), (dqkv2, parts2) = runs
    assert _same_bits(dqkv, dqkv2) and _same_bits(parts, parts2)
    got = dqkv.view(b, s, 3, h, dh).clone()
    assert torch.isnan(got[:, 0]).all()  # row 0 is K6's
    got[:, 0, 0] = 0
    got[:, 0, 1:] = parts.sum(2).permute(0, 2, 1, 3).to(torch.bfloat16)
    ref = divided_attention_backward_reference(
        qkv, g, scale=scale, axis="space", num_frames=frames, rows="grouped")
    errs = _rel_errs(got, ref)
    assert max(errs) <= BWD_RTOL[torch.bfloat16], errs


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [1, 4, 5, 16, 32])
def test_space_fwd_kernel_alone(cuda, frames):
    """K1 through its wrapper at the paths' frame size (N = 196, bf16,
    Dh=64): against the plain version on the same values in f32, row 0
    left alone, two runs on one input the same bits, and in the profiler's
    kernel names the one launch of the frame form."""
    b, n, h, dh = 2, 196, 3, 64
    s, scale = 1 + frames * n, dh ** -0.5
    qkv = _qkv(14, b, s, h, dh, torch.bfloat16, cuda)
    flat = qkv.view(b, s, -1)
    assert _kernels.space_fwd_geometry(torch.bfloat16, dh, s,
                                       frames).form == "frame"
    outs = []
    for _ in range(2):
        out = torch.full((b, s, h * dh), float("nan"), dtype=torch.bfloat16,
                         device=cuda)
        names = _profiled_names(lambda: _kernels.space_attention_fwd(
            flat, out, num_heads=h, num_frames=frames, scale=scale))
        outs.append(out)
    assert len(names) == 1 and "space_fwd_frame_kernel" in names[0], names
    assert _same_bits(outs[0], outs[1])
    assert torch.isnan(outs[0][:, 0]).all()
    ref = grouped_reference(qkv.float(), scale=scale, axis="space",
                            num_frames=frames).reshape(b, s - 1, h * dh)
    assert (outs[0][:, 1:].float() - ref).abs().max().item() \
        <= TOL[torch.bfloat16]


# (B, F, N, H, Dh) for K1 and K4 against the plain versions of their frame
# blocks: the paths' frame at one, four and 32 frames, an odd frame, the
# last frame on the forms (N = 207) and each head dim K4 takes.
SPACE_TWIN_CASES = [(2, 4, 196, 3, 64), (1, 1, 196, 2, 64),
                    (1, 32, 196, 2, 64), (2, 3, 33, 2, 16),
                    (1, 2, 207, 2, 48), (1, 5, 50, 2, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPACE_TWIN_CASES)
def test_space_frame_forms_match_their_plain_twins(cuda, case):
    """K1 and K4 in their frame forms (bf16) against the plain versions of
    their frame blocks on the same values: K1 against
    `space_frame_reference` within 2e-2, the largest abs error (its
    numerator rounded as K1 rounds it, the output rounded to bf16); K4
    against `space_frame_grad_reference` (P, dP, delta and dS in f32, P
    rounded only before dV and dS only before dQ/dK, as the TPU kernel
    rounds them), dq, dk and dv of the patch rows and each frame's dk/dv of
    the CLS key in `cls_part`, each within 2e-2 of its max |reference|."""
    b, f, n, h, dh = case
    s, scale = 1 + f * n, dh ** -0.5
    qkv = _qkv(15, b, s, h, dh, torch.bfloat16, cuda)
    g = _qkv(16, b, s, h, dh, torch.bfloat16, cuda)[:, :, 0].contiguous()
    flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
    kw = dict(num_heads=h, num_frames=f, scale=scale)
    assert _kernels.space_fwd_geometry(torch.bfloat16, dh, s, f).form \
        == "frame"
    assert _kernels.space_bwd_geometry(torch.bfloat16, dh, s, f).form \
        == "frame"
    out = torch.full((b, s, h * dh), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    _kernels.space_attention_fwd(flat, out, **kw)
    ref = space_frame_reference(qkv, scale=scale, num_frames=f)
    assert (out[:, 1:].float() - ref.float().reshape(b, s - 1, -1)
            ).abs().max().item() <= TOL[torch.bfloat16]
    stats, parts = _kernels.attention_bwd_scratch(flat, num_heads=h,
                                                  num_frames=f, axis="space")
    dqkv = torch.full_like(flat, float("nan"))
    _kernels.space_attention_bwd(flat, gflat, dqkv, stats, parts, **kw)
    torch.cuda.synchronize()
    want, want_cls = space_frame_grad_reference(qkv, g, scale=scale,
                                                num_frames=f)
    got = dqkv.view(b, s, 3, h, dh)[:, 1:].float()
    errs = [((got[:, :, i] - want[:, 1:, i]).abs().max()
             / want[:, 1:, i].abs().max()).item() for i in range(3)]
    errs += [((parts[:, :, :, i] - want_cls[:, :, :, i]).abs().max()
              / want_cls[:, :, :, i].abs().max()).item() for i in range(2)]
    assert max(errs) <= BWD_RTOL[torch.bfloat16], errs


@pytest.mark.gpu
def test_space_frame_forms_refuse_a_geometry_that_does_not_hold(cuda):
    """The frame forms' C entry points launch `space_fwd_geometry`'s and
    `space_bwd_geometry`'s geometry as given and refuse any other (CUDA
    error 1): other blocks a (b, h), other shared memory, f32, a head dim
    off the form, a frame of more than 208 keys; and the grouped entry
    points refuse the frame geometry."""
    b, n, h, dh, frames = 2, 20, 3, 64, 4
    s = 1 + frames * n
    flat = _qkv(15, b, s, h, dh, torch.bfloat16, cuda).view(b, s, -1)
    g = torch.zeros((b, s, h * dh), dtype=torch.bfloat16, device=cuda)
    out, dqkv = torch.empty_like(g), torch.empty_like(flat)
    cls_part = torch.empty((b, h, frames, 2, dh), device=cuda)
    stats = torch.empty((2, b, h, s), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fwd = _kernels.space_fwd_geometry(torch.bfloat16, dh, s, frames)
    bwd = _kernels.space_bwd_geometry(torch.bfloat16, dh, s, frames)

    def launch_fwd(parts, shared, dtype=1, d=dh, ss=s):
        return _kernels.load().space_attention_fwd_frame(
            flat.data_ptr(), out.data_ptr(), dtype, b, ss, h, d, frames,
            0.125, parts, shared, stream)

    def launch_bwd(parts, shared, dtype=1, d=dh, ss=s):
        return _kernels.load().space_attention_bwd_frame(
            flat.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            cls_part.data_ptr(), dtype, b, ss, h, d, frames, 0.125, parts,
            shared, stream)

    assert launch_fwd(fwd.parts, fwd.shared_bytes) == 0
    assert launch_bwd(bwd.parts, bwd.shared_bytes) == 0
    torch.cuda.synchronize()
    for launch, geo in ((launch_fwd, fwd), (launch_bwd, bwd)):
        assert launch(geo.parts + 1, geo.shared_bytes) == 1
        assert launch(geo.parts, geo.shared_bytes + 16) == 1
        assert launch(geo.parts, geo.shared_bytes, dtype=0) == 1
        assert launch(geo.parts, geo.shared_bytes, d=72) == 1
        # N = 208: 14 key tiles
        assert launch(frames, geo.shared_bytes, ss=1 + frames * 208) == 1
    assert launch_bwd(bwd.parts, bwd.shared_bytes, d=80) == 1
    assert _kernels.load().space_attention_fwd(
        flat.data_ptr(), out.data_ptr(), 1, b, s, h, dh, frames, 0.125,
        fwd.rows, fwd.parts, stream) == 1
    assert _kernels.load().space_attention_bwd(
        flat.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        cls_part.data_ptr(), 1, b, s, h, dh, frames, 0.125, bwd.parts,
        stream) == 1


def _profiled_names(fn) -> list:
    """The kernels that `fn` runs, as the profiler names them, sorted: the
    union over three profiles of ten calls each, after a warm call. The
    tracer may miss launches in a profile (at the start of its window, and
    now and then every launch of one kernel: K8's sum at 2,112 rows), or
    hand back no event at all; a kernel that runs shows in the union."""
    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        names |= {e.key for e in prof.key_averages()
                  if e.self_device_time_total}
    return sorted(names)


# K2's kernels by form, as the profiler names them
TIME_FWD_KERNELS = {"tensor_cores": "time_fwd_tc_kernel",
                    "grouped": "time_fwd_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("frames", [4, 5, 7, 16, 32, 63])
def test_time_fwd_tensor_cores_match_plain(cuda, frames, dh):
    """K2's tensor-core form, which the geometry names at each of these
    shapes, through its wrapper: rows 1..S-1 against the plain version on
    the same values in f32 within 2e-2 (one to four key tiles, one to four
    query tiles), row 0 left alone; N = 11 leaves the last block fewer
    columns than `cols` where F < 16."""
    b, n, h = 2, 11, 3
    s, scale = 1 + frames * n, dh ** -0.5
    qkv = _qkv(9, b, s, h, dh, torch.bfloat16, cuda)
    flat = qkv.view(b, s, -1)
    ref = grouped_reference(qkv.float(), scale=scale, axis="time",
                            num_frames=frames).reshape(b, s - 1, h * dh)
    geo = _kernels.time_fwd_geometry(torch.bfloat16, dh, s, frames)
    assert geo.form == "tensor_cores"
    out = torch.full((b, s, h * dh), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    _kernels.time_attention_fwd(flat, out, num_heads=h, num_frames=frames,
                                scale=scale)
    torch.cuda.synchronize()
    assert torch.isnan(out[:, 0]).all()
    err = (out[:, 1:].float() - ref).abs().max().item()
    assert err <= TOL[torch.bfloat16], (geo, err)


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [4, 5, 16, 32])
def test_time_fwd_kernel_alone(cuda, frames):
    """K2 through its wrapper at the paths' frame counts (bf16, Dh=64):
    against the plain version on the same values in f32, two runs on one
    input the same bits, and in the profiler's kernel names the one launch
    of the form `time_fwd_geometry` names."""
    b, n, h, dh = 2, 30, 3, 64
    s, scale = 1 + frames * n, dh ** -0.5
    qkv = _qkv(10, b, s, h, dh, torch.bfloat16, cuda)
    flat = qkv.view(b, s, -1)
    form = _kernels.time_fwd_geometry(torch.bfloat16, dh, s, frames).form
    outs = []
    for _ in range(2):
        out = torch.full((b, s, h * dh), float("nan"), dtype=torch.bfloat16,
                         device=cuda)
        names = _profiled_names(lambda: _kernels.time_attention_fwd(
            flat, out, num_heads=h, num_frames=frames, scale=scale))
        outs.append(out)
    assert len(names) == 1 and TIME_FWD_KERNELS[form] in names[0], names
    assert _same_bits(outs[0], outs[1])
    ref = grouped_reference(qkv.float(), scale=scale, axis="time",
                            num_frames=frames).reshape(b, s - 1, h * dh)
    assert (outs[0][:, 1:].float() - ref).abs().max().item() \
        <= TOL[torch.bfloat16]


@pytest.mark.gpu
def test_time_attention_fwd_tc_refuses_a_geometry_that_does_not_hold(cuda):
    """K2's tensor-core C entry point launches `time_fwd_geometry`'s
    geometry as given and refuses any other (CUDA error 1): other columns a
    block, blocks that do not cover N, other shared memory, f32, F > 63."""
    b, n, h, dh, frames = 2, 13, 3, 64, 4
    s = 1 + frames * n
    flat = _qkv(11, b, s, h, dh, torch.bfloat16, cuda).view(b, s, -1)
    out = torch.empty((b, s, h * dh), dtype=torch.bfloat16, device=cuda)
    geo = _kernels.time_fwd_geometry(torch.bfloat16, dh, s, frames)

    def launch(g, dtype=1, f=frames):
        return _kernels.load().time_attention_fwd_tc(
            flat.data_ptr(), out.data_ptr(), dtype, b, s, h, dh, f, 0.125,
            g.cols, g.parts, g.shared_bytes,
            torch.cuda.current_stream(cuda).cuda_stream)

    assert launch(geo) == 0
    torch.cuda.synchronize()
    bad = [dict(cols=geo.cols + 1), dict(cols=geo.cols - 1),
           dict(parts=geo.parts + 1), dict(parts=geo.parts - 1),
           dict(shared_bytes=geo.shared_bytes + 16)]
    for change in bad:
        assert launch(SimpleNamespace(**{**vars(geo), **change})) == 1, change
    assert launch(geo, dtype=0) == 1
    assert launch(geo, f=64) == 1


def _cls_row_forward(flat, h, scale):
    """K3 on flat qkv [B, S, 3*H*Dh]: (the output, rows 1..S-1 NaN, lse0)."""
    b, s, w3 = flat.shape
    out = torch.full((b, s, w3 // 3), float("nan"), dtype=flat.dtype,
                     device=flat.device)
    lse0 = torch.full((b, h), float("nan"), device=flat.device)
    _kernels.cls_row_attention_fwd(flat, out, lse0, num_heads=h, scale=scale)
    return out, lse0


def _same_bits(x, y):
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return torch.equal(x.view(ints[x.dtype]), y.view(ints[y.dtype]))


# (B, S, H, Dh) for K3/K6 alone. A run of `cls_row_geometry` is 128 keys at
# Dh=64, 64 at Dh=128 and 1024 at Dh=8: S not a multiple of the run, S
# under one run, a last run of one key, the widest and the narrowest head
# dim, and the 32-frame fine-tune's S.
CLS_ROW_CASES = [(2, 785, 3, 64), (3, 33, 2, 64), (1, 257, 2, 64),
                 (2, 401, 2, 128), (2, 97, 3, 8), (1, 6273, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CLS_ROW_CASES)
def test_cls_row_kernels_over_key_runs(cuda, case, dtype):
    """K3 and K6 alone over runs of keys: K3's row 0 against the plain
    version (the same values in f32), its lse0 against `row_lse_reference`
    within 1e-5 of max |reference|, K6 (from K3's output and lse0, on a
    zeroed dqkv and zero partials) against the gradient of row 0; K3 leaves
    rows 1..S-1 alone; each run twice on one input gives the same bits
    (partials summed in a fixed order, no atomics); one launch count a
    call."""
    b, s, h, dh = case
    scale = dh ** -0.5
    qkv = _qkv(5, b, s, h, dh, dtype, cuda)
    g = _qkv(6, b, s, h, dh, dtype, cuda)[:, :, 0].contiguous()
    flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
    before = dict(_kernels.launch_counts)
    (out, lse0), (out2, lse2) = (_cls_row_forward(flat, h, scale)
                                 for _ in range(2))
    cls_part = torch.zeros((b, h, 3, 2, dh), device=cuda)
    dqkv, dqkv2 = (torch.zeros_like(flat) for _ in range(2))
    for d in (dqkv, dqkv2):
        _kernels.cls_row_attention_bwd(flat, gflat, out, lse0, d, cls_part,
                                       num_heads=h, scale=scale)
    torch.cuda.synchronize()
    assert _same_bits(out[:, :1], out2[:, :1]) and _same_bits(lse0, lse2)
    assert _same_bits(dqkv, dqkv2)
    assert torch.isnan(out[:, 1:]).all()
    ref = cls_row_reference(qkv.float(), scale=scale).reshape(b, 1, h * dh)
    assert (out[:, :1].float() - ref).abs().max().item() <= TOL[dtype]
    lse_ref = row_lse_reference(qkv, scale=scale, axis="space",
                                num_frames=1)[:, :, 0]
    assert ((lse0 - lse_ref).abs().max() / lse_ref.abs().max()).item() <= 1e-5
    dref = divided_attention_backward_reference(qkv, g, scale=scale,
                                                axis="space", num_frames=1,
                                                rows="cls")
    errs = _rel_errs(dqkv.view(b, s, 3, h, dh), dref)
    assert max(errs) <= BWD_RTOL[dtype], errs
    assert _kernels.launch_counts["cls_row_attention_fwd"] \
        == before["cls_row_attention_fwd"] + 2
    assert _kernels.launch_counts["cls_row_attention_bwd"] \
        == before["cls_row_attention_bwd"] + 2


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    out = torch.empty(1, 5, 2 * 12, device=cuda)
    with pytest.raises(ValueError, match="head dim"):  # Dh = 12
        _kernels.space_attention_fwd(torch.zeros(1, 5, 72, device=cuda), out,
                                     num_heads=2, num_frames=2, scale=1.0)
    with pytest.raises(TypeError):
        _kernels.cls_row_attention_fwd(
            torch.zeros(1, 5, 48, device=cuda, dtype=torch.float16),
            out.half(), torch.empty(1, 2, device=cuda), num_heads=2,
            scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):  # every 2nd column
        _kernels.space_attention_fwd(
            torch.zeros(1, 5, 192, device=cuda)[:, :, ::2],
            torch.empty(1, 5, 32, device=cuda), num_heads=2, num_frames=2,
            scale=1.0)
    # a view K1-K6 cannot read: divided_attention takes K10 instead
    qkv = _qkv(1, 9, 2, 2, 8, device=cuda).transpose(0, 1)  # [2, 9, 3, 2, 8]
    before = _kernels.launch_counts["divided_attention_general_fwd"]
    got = divided_attention(qkv, scale=0.3, axis="space", num_frames=4)
    ref = divided_attention_reference(qkv, scale=0.3, axis="space",
                                      num_frames=4)
    assert (got - ref).abs().max().item() <= TOL[torch.float32]
    assert _kernels.launch_counts["divided_attention_general_fwd"] == before + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        divided_attention(qkv.half(), scale=0.3, axis="space", num_frames=4)
    with pytest.raises(ValueError, match="head dim"):
        _kernels.divided_attention_general_fwd(
            torch.zeros(1, 5, 3, 1, 264, device=cuda),
            torch.zeros(1, 5, 1, 264, device=cuda),
            torch.zeros(1, 1, 5, device=cuda), scale=1.0, axis="time",
            num_frames=2)


# The general divided attention (K10, K11): every CUDA input K1-K6 do not
# take. (layout, dtype, axis, B, F, N, H, Dh): the EgoTaskQA step's shape
# (f32) on the packed projection and on a permuted [3, B, H, S, Dh] tensor,
# rows 3/4's frame-block regime (f32, space, 6 frames), row 1d's regime
# (bf16, time, F=12, N=64: K10/K11 on a strided view, as K1-K6 take the
# contiguous one) and an odd head dim. bf16 forward against the plain
# version on the same values in f32.
GENERAL_CASES = [
    ("packed", torch.float32, "space", 8, 4, 196, 12, 64),
    ("packed", torch.float32, "time", 8, 4, 196, 12, 64),
    ("permuted", torch.float32, "space", 8, 4, 196, 12, 64),
    ("permuted", torch.float32, "time", 8, 4, 196, 12, 64),
    ("packed", torch.float32, "space", 2, 6, 196, 12, 64),
    ("permuted", torch.bfloat16, "time", 16, 12, 64, 12, 64),
    ("packed", torch.float32, "space", 2, 3, 10, 2, 12),
    ("packed", torch.bfloat16, "time", 2, 3, 10, 2, 12),
]


def _general_qkv(seed, layout, b, s, h, dh, dtype, device):
    """qkv [B, S, 3, H, Dh]: contiguous, or a permute of [3, B, H, S, Dh]."""
    if layout == "packed":
        return _qkv(seed, b, s, h, dh, dtype, device)
    x = np.random.RandomState(seed).randn(3, b, h, s, dh).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype).permute(1, 3, 0, 2, 4)


@pytest.mark.parametrize("layout, dtype, other", [
    ("packed", torch.bfloat16, {}), ("packed", torch.float32, {}),
    ("packed", torch.bfloat16, {"dh": 12}), ("packed", torch.bfloat16, {"dh": 136}),
    ("permuted", torch.bfloat16, {}), ("offset", torch.bfloat16, {})])
def test_one_predicate_picks_the_kernels(layout, dtype, other):
    """K1-K6 take bf16, contiguous, 16-byte aligned, Dh a multiple of 8 up
    to 128; K10/K11 everything else."""
    dh = other.get("dh", 16)
    if layout == "offset":  # contiguous but 2 bytes past an aligned start
        qkv = torch.zeros(1 + 5 * 3 * 2 * dh, dtype=dtype)[1:].view(1, 5, 3, 2, dh)
        assert qkv.is_contiguous() and qkv.data_ptr() % 16
    else:
        qkv = _general_qkv(0, layout, 1, 5, 2, dh, dtype, "cpu")
    want = (layout == "packed" and dtype == torch.bfloat16 and dh % 8 == 0
            and dh <= 128)
    assert grouped_kernels_take(qkv) == want


@pytest.mark.gpu
@pytest.mark.parametrize("case", GENERAL_CASES)
def test_general_kernels_match_plain(cuda, case):
    """K10 and K11 through `divided_attention` and its backward, no input
    copied (dqkv comes back in qkv's layout): forward within 1e-4 (f32) /
    2e-2 (bf16) of the plain version on the same values in f32; dq, dk, dv
    within 1e-4 / 2e-2 of max |reference|, the CLS row and the patch rows
    each by its own maximum."""
    layout, dtype, axis, b, f, n, h, dh = case
    s = 1 + f * n
    qkv = _general_qkv(0, layout, b, s, h, dh, dtype, cuda)
    assert not grouped_kernels_take(qkv) or layout == "packed"
    g = _qkv(1, b, s, h, dh, dtype, cuda)[:, :, 1]  # a strided view
    leaf = qkv.detach().requires_grad_(True)
    before = dict(_kernels.launch_counts)
    out = divided_attention(leaf, scale=dh ** -0.5, axis=axis, num_frames=f)
    # saved for K11 without a copy: qkv itself, the output, K10's lse
    saved_qkv, saved_out, lse = out.grad_fn.saved_tensors
    assert saved_qkv.data_ptr() == leaf.data_ptr()
    assert saved_out.data_ptr() == out.data_ptr()
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    kw = dict(scale=dh ** -0.5, axis=axis, num_frames=f)
    lse_ref = row_lse_reference(qkv, **kw)
    assert ((lse - lse_ref).abs().max() / lse_ref.abs().max()).item() <= 1e-5
    del saved_qkv, saved_out, lse
    out.backward(g)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _kernels.launch_counts.items()
                if v != before[k]}
    assert launched == {"divided_attention_general_fwd": 1,
                        "divided_attention_general_bwd": 1}
    ref = divided_attention_reference(qkv.float(), **kw)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert leaf.grad.stride() == qkv.stride()
    dref = divided_attention_backward_reference(qkv, g, scale=dh ** -0.5,
                                                axis=axis, num_frames=f)
    errs = _rel_errs(leaf.grad, dref)
    assert max(errs) <= BWD_RTOL[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["packed", "permuted", "offset"])
@pytest.mark.parametrize("dh", [1, 3, 12, 33, 64, 100, 129, 256])
def test_general_fwd_any_head_dim_and_view(cuda, dh, layout, dtype):
    """K10's tiles at head dims that fill 1 to 4 column groups a thread, on
    a contiguous qkv (16-byte copies where the rows allow), a permuted one
    and one two elements past an aligned start (element copies), both axes,
    with groups whose rows end part-way through a tile (N = 70: two query
    tiles a frame; F = 3: 21 columns a time group): within 1e-4 (f32) / 2e-2
    (bf16) of the plain version on the same values in f32, each row's lse
    within 1e-5 of max |reference| (the inputs are exact in f32 either
    way), and the same bits from two runs."""
    b, f, n, h = 2, 3, 70, 2
    s = 1 + f * n
    if layout == "offset":
        flat = torch.from_numpy(np.random.RandomState(5).randn(
            b * s * 3 * h * dh + 2).astype(np.float32)).to(cuda, dtype)
        qkv = flat[2:].view(b, s, 3, h, dh)
    else:
        qkv = _general_qkv(5, layout, b, s, h, dh, dtype, cuda)
    for axis in ("space", "time"):
        kw = dict(scale=dh ** -0.5, axis=axis, num_frames=f)
        outs = [torch.full((b, s, h, dh), float("nan"), dtype=dtype,
                           device=cuda) for _ in range(2)]
        lses = [torch.full((b, h, s), float("nan"), device=cuda)
                for _ in range(2)]
        for out, lse in zip(outs, lses):
            _kernels.divided_attention_general_fwd(qkv, out, lse, **kw)
        torch.cuda.synchronize()
        ref = divided_attention_reference(qkv.float(), **kw)
        err = (outs[0].float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= TOL[dtype], (axis, err.item())
        lse_ref = row_lse_reference(qkv, **kw)
        lse_err = (lses[0] - lse_ref).abs().max() / lse_ref.abs().max()
        assert lse_err.item() <= 1e-5, (axis, lse_err.item())
        assert torch.equal(outs[0], outs[1]) and torch.equal(*lses)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["packed", "permuted", "offset"])
@pytest.mark.parametrize("dh", [1, 3, 12, 33, 64, 100, 129, 256])
def test_general_bwd_any_head_dim_and_view(cuda, dh, layout, dtype):
    """K11's query and key passes and merge at head dims that fill 1 to 4
    column groups a thread (and at 256 the 32-row streamed tiles), on the
    views of `test_general_fwd_any_head_dim_and_view`, both axes, with
    groups whose rows end part-way through a tile (N = 70; F = 3), from
    K10's output and lse and a strided cotangent: dq, dk, dv within 1e-4
    (f32) / 2e-2 (bf16) of max |reference| on the same values in f32, the
    CLS row and the patch rows each by its own maximum, dqkv in qkv's
    strides, and the same bits from two runs."""
    b, f, n, h = 2, 3, 70, 2
    s = 1 + f * n
    if layout == "offset":
        flat = torch.from_numpy(np.random.RandomState(6).randn(
            b * s * 3 * h * dh + 2).astype(np.float32)).to(cuda, dtype)
        qkv = flat[2:].view(b, s, 3, h, dh)
    else:
        qkv = _general_qkv(6, layout, b, s, h, dh, dtype, cuda)
    g = _qkv(7, b, s, h, dh, dtype, cuda)[:, :, 2]  # a strided view
    for axis in ("space", "time"):
        kw = dict(scale=dh ** -0.5, axis=axis, num_frames=f)
        out = torch.empty((b, s, h, dh), dtype=dtype, device=cuda)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
        _kernels.divided_attention_general_fwd(qkv, out, lse, **kw)
        grads = [torch.full_like(qkv, float("nan")) for _ in range(2)]
        for dqkv in grads:
            _kernels.divided_attention_general_bwd(qkv, out, lse, g, dqkv,
                                                   **kw)
        torch.cuda.synchronize()
        if layout != "offset":
            assert grads[0].stride() == qkv.stride()
        ref = divided_attention_backward_reference(qkv.float(), g.float(),
                                                   **kw)
        assert torch.isfinite(grads[0]).all()
        errs = _rel_errs(grads[0], ref)
        assert max(errs) <= BWD_RTOL[dtype], (axis, errs)
        assert torch.equal(grads[0], grads[1])


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
    _check_layernorm(cuda, *case, dtype, eps)


# The downstream heads' LayerNorms, f32 at flax's eps: VSLNet's video rows
# (batch 32 x 256) and query rows (32 x 15) at D = 128, the QFVS scorer's
# rows (20 segments x 200 shots) at D = 768.
HEAD_LN_CASES = ((32 * 256, 128), (32 * 15, 128), (20 * 200, 768))


@pytest.mark.gpu
@pytest.mark.parametrize("case", HEAD_LN_CASES)
def test_layernorm_kernels_at_the_heads_shapes(cuda, case):
    """The same at the heads' shapes, float32, eps 1e-6."""
    _check_layernorm(cuda, *case, torch.float32, 1e-6)


def _check_layernorm(cuda, r, d, dtype, eps):
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


# Row counts of K8 at few rows: one row, a block's group of rows at once
# cut short, the f32 EgoTaskQA text rows (120), the pretrain and fine-tune
# text rows (240), a last block that ends part-way, and the edge where the
# blocks run out (4 x 132 of them at 4 rows each at D=768) on both sides.
LN_EDGE = 4 * _kernels.LN_BWD_MAX_PARTS
LN_FEW_ROWS = [1, 2, 7, 120, 240, 301, LN_EDGE - 1, LN_EDGE, LN_EDGE + 1]
LN_BWD_KERNELS = ("layernorm_bwd_kernel", "layernorm_bwd_sum_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [768, 776, 2048, 8192])
@pytest.mark.parametrize("rows", LN_FEW_ROWS + [6280, 12560, 200768])
def test_layernorm_bwd_geometry(rows, d, dtype):
    """K8's split: blocks of 128 threads (or of one row group, where that
    is wider), the strips a whole number of the rows a block takes at once,
    covering the rows with a row for every block; one group of rows a block
    while that needs at most 4 blocks an SM, else the fewest rows a block
    that keep to them; the partials `layernorm_bwd_scratch` sizes are one a
    block."""
    geo = _kernels.layernorm_bwd_geometry(dtype, rows, d)
    assert geo.group * 32 >= d and (geo.group == 32 or geo.group * 16 < d)
    assert geo.at_once == max(geo.group, 128) // geo.group
    assert geo.strip % geo.at_once == 0
    assert (geo.parts - 1) * geo.strip < rows <= geo.parts * geo.strip
    assert geo.parts <= _kernels.LN_BWD_MAX_PARTS == 4 * 132
    if -(-rows // geo.at_once) <= _kernels.LN_BWD_MAX_PARTS:
        assert geo.strip == geo.at_once
    else:
        assert -(-rows // (geo.strip - geo.at_once)) \
            > _kernels.LN_BWD_MAX_PARTS
    x = torch.empty((rows, d), dtype=dtype, device="meta")
    assert tuple(_kernels.layernorm_bwd_scratch(x).shape) == (geo.parts, 2, d)


# K7's shapes: chip_smoke.py's phase 3 (LN_CASES, EgoMCQ 16f's 20 x 3137
# video rows among them, and the heads' HEAD_LN_CASES), a last block cut
# short, and the wider groups.
LN_FWD_SHAPES = [(16 * 785, 768), (8 * 6273, 768), (64 * 3137, 768),
                 (20 * 3137, 768), (16 * 981, 768), (240, 768), (301, 776),
                 (120, 768), (8 * 785, 768), (32 * 256, 128), (32 * 15, 128),
                 (20 * 200, 768), (2111, 768), (1, 768), (7, 8), (130, 1032),
                 (9, 2048), (3, 4096), (2, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, d", LN_FWD_SHAPES)
def test_layernorm_fwd_geometry(rows, d, dtype):
    """K7's geometry: the groups of K8 (128 threads a block, or one group
    where that is wider); a thread holds the 16-byte pieces of a row its
    group needs, at most 32 elements' worth: 24 elements at D = 768, 3
    pieces in bf16, 6 in f32."""
    geo = _kernels.layernorm_fwd_geometry(dtype, rows, d)
    bwd = _kernels.layernorm_bwd_geometry(dtype, rows, d)
    assert (geo.group, geo.at_once) == (bwd.group, bwd.at_once)
    per_piece = 16 // (torch.finfo(dtype).bits // 8)
    assert geo.slots == -(-d // (per_piece * geo.group))
    assert (geo.slots - 1) * per_piece * geo.group < d
    assert 1 <= geo.slots * per_piece <= 32
    if d == 768:
        assert (geo.group, geo.slots * per_piece) == (32, 24)


def test_layernorm_fwd_geometry_refuses_bad_input():
    geo = _kernels.layernorm_fwd_geometry
    with pytest.raises(TypeError, match="float16"):
        geo(torch.float16, 240, 768)
    for rows, d in ((0, 768), (240, 0), (240, 12), (240, 8200)):
        with pytest.raises(ValueError):
            geo(torch.bfloat16, rows, d)


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", LN_FEW_ROWS)
def test_layernorm_bwd_few_rows(cuda, rows, dtype, eps):
    """K8 at D=768 over the few rows of the paths and the edge of the
    split: dx within LN_TOL, dscale and dbias within 1e-3 of max
    |reference|, two runs on one input the same bits (the partials are
    added in a fixed order, no atomics), and the profiled kernels its two
    launches."""
    d = 768
    x, g, scale, _ = _ln_inputs(rows, d, dtype, cuda)
    runs = []
    for _ in range(2):
        out = (torch.full_like(x, float("nan")),
               torch.full_like(scale, float("nan")),
               torch.full_like(scale, float("nan")))
        names = _profiled_names(lambda: _kernels.layernorm_bwd(
            x, scale, g, *out, _kernels.layernorm_bwd_scratch(x), eps=eps))
        runs.append(out)
    assert len(names) == len(LN_BWD_KERNELS), names
    for kernel in LN_BWD_KERNELS:
        assert any(kernel in n for n in names), names
    for a, b in zip(*runs):
        assert _same_bits(a, b)
    dx, dscale, dbias = runs[0]
    ref_dx, ref_dscale, ref_dbias = ln.layernorm_backward_reference(
        x, scale, g, eps)
    assert _ln_rel(dx, ref_dx) <= LN_TOL[dtype]
    assert _ln_rel(dscale, ref_dscale) <= 1e-3
    assert _ln_rel(dbias, ref_dbias) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_shapes_back_to_back(cuda, dtype):
    """K8 on shapes of few and many rows and several widths, one call after
    the other on one stream before a synchronisation: each result as the
    plain backward gives it."""
    shapes = [(240, 768), (7, 776), (12560, 768), (120, 768), (3, 4096),
              (9, 2048), (240, 768)]
    results = []
    for rows, d in shapes:
        x, g, scale, _ = _ln_inputs(rows, d, dtype, cuda)
        dx, dscale, dbias = (torch.empty_like(x), torch.empty_like(scale),
                             torch.empty_like(scale))
        _kernels.layernorm_bwd(x, scale, g, dx, dscale, dbias,
                               _kernels.layernorm_bwd_scratch(x), eps=1e-5)
        results.append(((x, g, scale), (dx, dscale, dbias)))
    torch.cuda.synchronize()
    for (x, g, scale), (dx, dscale, dbias) in results:
        ref_dx, ref_dscale, ref_dbias = ln.layernorm_backward_reference(
            x, scale, g, 1e-5)
        assert _ln_rel(dx, ref_dx) <= LN_TOL[dtype]
        assert _ln_rel(dscale, ref_dscale) <= 1e-3
        assert _ln_rel(dbias, ref_dbias) <= 1e-3


def _launch_ln_fwd(x, scale, bias, y, eps, slots) -> int:
    rows, d = x.shape
    return _kernels.load().layernorm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        eps, _kernels._DTYPE_CODES[x.dtype], slots,
        torch.cuda.current_stream().cuda_stream)


# K7 at the row counts of chip_smoke.py's phase 3 (EgoMCQ 16f's video rows
# 20 x 3137 among them) and at its other group widths.
LN_FWD_CASES = [(12560, 768), (20 * 3137, 768), (240, 768), (301, 776),
                (32 * 256, 128), (130, 1032), (9, 2048), (2, 8192)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LN_FWD_CASES)
def test_layernorm_fwd_launches_its_geometry_and_refuses_others(cuda, case,
                                                               dtype):
    """K7 at the slots of `layernorm_fwd_geometry` through the C entry
    point: the same bits twice, within LN_TOL of the plain version, the
    profiled kernel its one launch; a slot more, where a thread may hold
    it, the same bits again; slots that do not cover the row, none, or
    more than 32 elements' worth are refused."""
    rows, d = case
    x, _, scale, bias = _ln_inputs(rows, d, dtype, cuda)
    geo = _kernels.layernorm_fwd_geometry(dtype, rows, d)
    most = 32 // (16 // x.element_size())
    outs = []
    for slots in (geo.slots, geo.slots, min(geo.slots + 1, most)):
        outs.append(torch.full_like(x, float("nan")))
        assert _launch_ln_fwd(x, scale, bias, outs[-1], 1e-5, slots) == 0
    torch.cuda.synchronize()
    assert _same_bits(*outs[:2]) and _same_bits(*outs[1:])
    ref = ln.layernorm_reference(x, scale, bias, eps=1e-5)
    assert _ln_rel(outs[0], ref) <= LN_TOL[dtype]
    names = _profiled_names(lambda: _kernels.layernorm_fwd(
        x, scale, bias, outs[0], eps=1e-5))
    assert len(names) == 1 and "layernorm_fwd_kernel" in names[0], names
    for slots in (0, geo.slots - 1, most + 1):
        assert _launch_ln_fwd(x, scale, bias, outs[1], 1e-5, slots) == 1


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
    # projection); t2i (few queries, the keys split over blocks by
    # `flash_fwd_geometry`, the splits merged by a second launch);
    # lengths above the JAX package's threshold; an odd case; one query row;
    # one key; the narrowest and the widest head dim; head dims that are not
    # a multiple of 8 (element by element, rows off 16-byte alignment).
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
    (2, 2, 37, 33, 12, "heads", "mask"),
    (1, 3, 40, 20, 100, "packed", None),
    # the few-query form at several splits: EgoMCQ's t2i at B=2; a split
    # whose keys are all masked in batch row 0 (it must weigh exactly 0),
    # Dh=32; two row tiles at Dh=128; Sk = run + 1 (a last split of one key)
    (2, 12, 15, 3137, 64, "heads", None),
    (2, 2, 15, 1100, 32, "heads", "masked_split"),
    (1, 2, 30, 1500, 128, "heads", "mask"),
    (1, 2, 15, 257, 64, "heads", None),
    (5, 12, 15, 3137, 64, "heads", "mask"),  # EgoMCQ 16f, one question
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
        if bias_kind == "masked_split":  # the second run of keys, batch 0
            run = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b,
                                              h).run
            assert sk > 2 * run
            mask[0, run:2 * run] = 0
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
def test_fused_attention_refuses_a_geometry_that_does_not_hold(cuda):
    """The C entry point launches `flash_fwd_geometry`'s geometry as given
    and refuses any other: another form, a run that is not a multiple of
    128 (FLASH_CHUNK; 100 and 192, a multiple of 64 only), splits that do
    not cover Sk, the wrong row tiles, stages or shared memory."""
    q, k, v, _ = _flash_inputs((2, 2, 15, 300, 64, "heads", None),
                               torch.bfloat16, cuda)
    out = torch.empty_like(q)
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, 64, 15, 300, 2, 2)
    partials = _kernels.flash_fwd_scratch(q, geo)
    assert geo.splits == 2 and partials is not None

    def launch(g):
        b, h, sq, dh = q.shape
        strides = [x for t in (q, k, v, out)
                   for x in _kernels.attention_strides(t)]
        return _kernels.load().fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            partials.data_ptr(), 1, b, h, sq, k.shape[2], dh, *strides, 0, 0,
            0.125, _kernels._FLASH_FORMS[g.form], g.run, g.splits, g.row_tiles, g.stages,
            g.shared_bytes, torch.cuda.current_stream(cuda).cuda_stream)

    assert launch(geo) == 0
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float(),
                                          scale=0.125)
    assert _flash_rel(out, ref) <= FLASH_TOL[torch.bfloat16]
    bad = [dict(form="many_queries"), dict(form="many_queries_tf32"),
           dict(form="few_queries_tf32"),
           dict(run=100), dict(run=192), dict(splits=geo.splits + 1),
           dict(row_tiles=2), dict(stages=3),
           dict(shared_bytes=geo.shared_bytes - 256)]
    for change in bad:
        assert launch(SimpleNamespace(**{**vars(geo), **change})) == 1, change


def _launch_flash(q, k, v, bias, out, geo, scale, partials=None) -> int:
    """One K9 call at the geometry `geo` through the C entry point, as the
    wrapper makes it (its partials, unless given); returns its code (0, or
    1 for a refused geometry)."""
    b, h, sq, dh = q.shape
    if partials is None:
        partials = _kernels.flash_fwd_scratch(q, geo)
    strides = [x for t in (q, k, v, out) for x in _kernels.attention_strides(t)]
    return _kernels.load().fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        _kernels._DTYPE_CODES[q.dtype], b, h, sq, k.shape[2], dh, *strides,
        0 if bias is None or bias.shape[0] == 1 else bias.stride(0), 0,
        float(scale), _kernels._FLASH_FORMS[geo.form], geo.run or 0,
        geo.splits, geo.row_tiles or 0, geo.stages or 0,
        geo.shared_bytes or 0, torch.cuda.current_stream().cuda_stream)


def _heads_out(q):
    """[B, H, Sq, Dh] over a [B, Sq, H, Dh] buffer, as the wrapper writes."""
    b, h, sq, dh = q.shape
    return torch.empty_strided((b, h, sq, dh), (sq * h * dh, dh, h * dh, 1),
                               dtype=q.dtype, device=q.device)


# K9's ring form (bf16, Dh 32/64/128, Sq > 32 over Sk <= 64): the i2t shapes
# of the paths and of chip_smoke.py's phase 3 (pretrain, EgoMCQ 16f, an NLQ
# inner batch, QFVS; the fine-tunes' 30 tokens), the 64 x 64 case, an odd
# Sq (a last slab of 5 rows), one key, the other head dims and key tiles:
# (B, H, Sq, Sk, Dh, layout, bias).
RING_CASES = [
    (16, 12, 785, 15, 64, "packed", "masked_row"),
    (20, 12, 3137, 15, 64, "packed", "masked_row"),
    (64, 12, 3137, 15, 64, "packed", "masked_row"),
    (16, 12, 981, 15, 64, "packed", "masked_row"),
    (8, 12, 785, 30, 64, "packed", "mask"),
    (16, 12, 64, 64, 64, "heads", "mask"),
    (3, 5, 37, 33, 32, "heads", "masked_row"),
    (2, 3, 100, 17, 128, "plain", None),
    (1, 2, 33, 1, 64, "heads", None),
    (2, 2, 6273, 15, 64, "packed", "mask"),
]
_CHUNKED = SimpleNamespace(form="many_queries_chunked", run=None, splits=1,
                           row_tiles=None, stages=None, key_tiles=None,
                           shared_bytes=None)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_form_matches_plain_and_the_chunked_form_bit_for_bit(cuda,
                                                                  case):
    """The ring form through `flash_attention` against the plain version
    (within 4e-3 of max |reference|; a fully masked batch row uniform over
    its keys), its profiled kernel `fused_ring_kernel`; and against the
    chunked form launched on the same inputs: the same mma products in the
    same order, so the same bits."""
    b, h, sq, sk, dh = case[:5]
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b, h)
    assert geo.form == "many_queries"
    q, k, v, bias = _flash_inputs(case, torch.bfloat16, cuda)
    before = dict(_kernels.flash_form_counts)
    got = flash.flash_attention(q, k, v, scale=dh ** -0.5, bias=bias)
    torch.cuda.synchronize()
    assert _kernels.flash_form_counts["many_queries"] \
        == before["many_queries"] + 1
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float(),
                                          scale=dh ** -0.5, bias=bias)
    assert torch.isfinite(got).all()
    assert _flash_rel(got, ref) <= FLASH_TOL[torch.bfloat16]
    if case[6] == "masked_row":
        uniform = v[0].float().mean(dim=-2, keepdim=True).expand(h, sq, dh)
        assert _flash_rel(got[0], uniform) <= FLASH_TOL[torch.bfloat16]
    chunked = _heads_out(q)
    assert _launch_flash(q, k, v, bias, chunked, _CHUNKED, dh ** -0.5) == 0
    torch.cuda.synchronize()
    assert _same_bits(got, chunked)
    names = _profiled_kernels(lambda: flash.flash_attention(
        q, k, v, scale=dh ** -0.5, bias=bias))
    assert len(names) == 1 and "fused_ring_kernel" in next(iter(names)), names


@pytest.mark.gpu
@pytest.mark.parametrize("case", [RING_CASES[0], RING_CASES[6],
                                  RING_CASES[7]])
def test_ring_form_gives_the_same_bits_at_any_run_it_takes(cuda, case):
    """The ring form at other runs of rows (one slab, a run that is not a
    multiple of 64, all of Sq in one block) gives the bits of the
    geometry's own choice: the run changes only which warp multiplies
    which rows, and when."""
    b, h, sq, sk, dh = case[:5]
    q, k, v, bias = _flash_inputs(case, torch.bfloat16, cuda)
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b, h)
    want = _heads_out(q)
    assert _launch_flash(q, k, v, bias, want, geo, dh ** -0.5) == 0
    for run in (16, 48, 1024, -(-sq // 16) * 16):
        other = SimpleNamespace(**{**vars(geo), "run": run,
                                   "splits": -(-sq // run)})
        out = _heads_out(q)
        assert _launch_flash(q, k, v, bias, out, other, dh ** -0.5) == 0
        torch.cuda.synchronize()
        assert _same_bits(out, want), run


@pytest.mark.gpu
def test_fused_attention_refuses_a_ring_geometry_that_does_not_hold(cuda):
    """The C entry point launches the ring form's geometry as given and
    refuses any other: a run of rows off a whole slab of 16, splits that do
    not cover Sq, a ring of 1 or 3 slabs, row tiles, other shared memory,
    the ring form over more than 64 keys, the chunked form with a ring
    geometry, either form given partials; the chunked form at its own
    geometry launches."""
    case = (2, 2, 100, 15, 64, "heads", None)
    q, k, v, _ = _flash_inputs(case, torch.bfloat16, cuda)
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, 64, 100, 15, 2, 2)
    assert (geo.form, geo.key_tiles) == ("many_queries", 1)
    out = _heads_out(q)
    assert _launch_flash(q, k, v, None, out, geo, 0.125) == 0
    assert _launch_flash(q, k, v, None, out, _CHUNKED, 0.125) == 0
    torch.cuda.synchronize()
    bad = [dict(run=100), dict(run=0), dict(splits=geo.splits + 1),
           dict(stages=1), dict(stages=3), dict(row_tiles=1),
           dict(shared_bytes=geo.shared_bytes - 16),
           dict(form="many_queries_chunked"), dict(form="few_queries")]
    for change in bad:
        g = SimpleNamespace(**{**vars(geo), **change})
        assert _launch_flash(q, k, v, None, out, g, 0.125) == 1, change
    qk, kk, vk, _ = _flash_inputs((2, 2, 100, 65, 64, "heads", None),
                                  torch.bfloat16, cuda)
    assert _kernels.flash_fwd_geometry(torch.bfloat16, 64, 100, 65, 2,
                                       2).form == "many_queries_chunked"
    assert _launch_flash(qk, kk, vk, None, _heads_out(qk), geo, 0.125) == 1
    spare = torch.empty(16, device=cuda)
    for g in (geo, _CHUNKED):
        assert _kernels.flash_fwd_scratch(q, g) is None
        assert _launch_flash(q, k, v, None, out, g, 0.125, spare) == 1


# The 3xTF32 forms at the shapes the paths give them, and at head dims off
# the bf16 forms: (B, H, Sq, Sk, Dh, layout, bias, the form the geometry
# names in f32; in bf16 the odd head dims take the same form).
TF32_CASES = [
    (8, 12, 785, 15, 64, "packed", "masked_row", "many_queries_tf32"),
    (8, 12, 15, 785, 64, "heads", "masked_row", "few_queries_tf32"),
    (8, 12, 15, 15, 64, "heads", "masked_row", "few_queries_tf32"),
    (2, 3, 37, 33, 40, "heads", "masked_row", "many_queries_tf32"),
    (2, 3, 15, 300, 40, "heads", "masked_row", "few_queries_tf32"),
    (2, 2, 31, 77, 12, "heads", "masked_row", "few_queries_tf32"),
    (2, 2, 100, 77, 12, "heads", "masked_row", "many_queries_tf32"),
    (2, 2, 20, 300, 100, "heads", "masked_row", "few_queries_tf32"),
    (1, 2, 40, 70, 100, "packed", "masked_row", "many_queries_tf32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case, dtype", [
    (case, dtype) for case in TF32_CASES
    for dtype in (torch.float32, torch.bfloat16)
    if dtype == torch.float32 or case[4] not in (32, 64, 128)])
def test_tf32_forms_match_plain(cuda, case, dtype):
    """Each 3xTF32 form (float32; bf16 at a head dim other than 32, 64 or
    128) against `flash_attention_reference` on the same values in f32:
    within 1e-4 (f32) / 4e-3 (bf16) of max |reference|; the fully masked
    batch row uniform over its keys; two runs the same bits; the form and
    its kernels as `flash_fwd_geometry` names them."""
    b, h, sq, sk, dh = case[:5]
    form = case[7]
    geo = _kernels.flash_fwd_geometry(dtype, dh, sq, sk, b, h)
    assert geo.form == form
    q, k, v, bias = _flash_inputs(case[:7], dtype, cuda)
    before = dict(_kernels.flash_form_counts)
    runs = [flash.flash_attention(q, k, v, scale=dh ** -0.5, bias=bias)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.flash_form_counts[form] == before[form] + 2
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float(),
                                          scale=dh ** -0.5, bias=bias)
    assert torch.isfinite(runs[0]).all()
    assert _flash_rel(runs[0], ref) <= FLASH_TOL[dtype]
    uniform = v[0].float().mean(dim=-2, keepdim=True).expand(h, sq, dh)
    assert _flash_rel(runs[0][0], uniform) <= FLASH_TOL[dtype]
    assert torch.equal(runs[0], runs[1])
    names = _profiled_kernels(lambda: flash.flash_attention(
        q, k, v, scale=dh ** -0.5, bias=bias))
    kernel = "fused_tf32_fwd_kernel" if form.startswith("many") \
        else "fused_tf32_split_kernel"
    assert any(kernel in n for n in names), names
    assert any("fused_merge_kernel" in n for n in names) == (geo.splits > 1)
    assert len(names) == 1 + (geo.splits > 1), names


def _profiled_kernels(fn, calls=10):
    """The names of the device kernels that `calls` calls of `fn` ran, after
    3 warm ones (the tracer can drop a window's first launch, so one call
    is not enough). A profile that holds no device event is taken again,
    twice at most."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total}
        if names:
            return names
    raise AssertionError("torch.profiler recorded no device event in three "
                         "profiles")


@pytest.mark.gpu
def test_fused_attention_refuses_a_tf32_geometry_that_does_not_hold(cuda):
    """The 3xTF32 forms' geometry as the C entry point checks it: the f32
    few-query form at the EgoTaskQA t2i (four runs of 256 keys) launches as
    given and matches the plain version; another form, a run off its 32-key
    chunk, splits that do not cover Sk, other row tiles, stages or shared
    memory are refused (CUDA error 1), as is the many-query form with
    other shared memory."""
    q, k, v, _ = _flash_inputs((8, 12, 15, 785, 64, "heads", None),
                               torch.float32, cuda)
    out = torch.empty_like(q)
    geo = _kernels.flash_fwd_geometry(torch.float32, 64, 15, 785, 8, 12)
    assert (geo.form, geo.run, geo.splits) == ("few_queries_tf32", 256, 4)
    partials = _kernels.flash_fwd_scratch(q, geo)

    def launch(g, q=q, k=k, v=v, out=out):
        b, h, sq, dh = q.shape
        strides = [x for t in (q, k, v, out)
                   for x in _kernels.attention_strides(t)]
        return _kernels.load().fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            partials.data_ptr(), 0, b, h, sq, k.shape[2], dh, *strides, 0, 0,
            0.125, _kernels._FLASH_FORMS[g.form], g.run or 0, g.splits,
            g.row_tiles or 0, g.stages or 0, g.shared_bytes,
            torch.cuda.current_stream(cuda).cuda_stream)

    assert launch(geo) == 0
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, scale=0.125)
    assert _flash_rel(out, ref) <= FLASH_TOL[torch.float32]
    bad = [dict(form="few_queries"), dict(form="many_queries_tf32"),
           dict(run=80), dict(splits=geo.splits + 1),
           dict(row_tiles=2), dict(stages=3),
           dict(shared_bytes=geo.shared_bytes - 256)]
    for change in bad:
        assert launch(SimpleNamespace(**{**vars(geo), **change})) == 1, change
    qi, ki, vi, _ = _flash_inputs((2, 12, 785, 15, 64, "packed", None),
                                  torch.float32, cuda)
    many = _kernels.flash_fwd_geometry(torch.float32, 64, 785, 15, 2, 12)
    assert launch(many, qi, ki, vi, torch.empty_like(qi)) == 0
    assert launch(SimpleNamespace(**{**vars(many), "shared_bytes":
                                     many.shared_bytes + 4}),
                  qi, ki, vi, torch.empty_like(qi)) == 1


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
    lse0 = torch.zeros(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.cls_row_attention_fwd(qkv, out, lse0, num_heads=2, scale=1.0)
    dq = torch.zeros_like(qkv)
    stats, parts = torch.zeros(2, 1, 2, 5), torch.zeros(1, 2, 1, 2, 8)
    for launch in (_kernels.space_attention_bwd, _kernels.time_attention_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            launch(qkv, out, dq, stats, parts, num_heads=2, num_frames=2,
                   scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.cls_row_attention_bwd(qkv, out, out, lse0, dq, parts,
                                       num_heads=2, scale=1.0)
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
    q5, lse = torch.zeros(1, 5, 3, 2, 8), torch.zeros(1, 2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.divided_attention_general_fwd(q5, q5[:, :, 0], lse,
                                               scale=1.0, axis="space",
                                               num_frames=2)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.divided_attention_general_bwd(q5, q5[:, :, 0], lse,
                                               q5[:, :, 1], q5, scale=1.0,
                                               axis="time", num_frames=2)
    assert set(libs) == {"divided_attention.cu", "divided_attention_bwd.cu",
                         "space_attention.cu", "time_attention.cu",
                         "layernorm.cu", "fused_attention.cu",
                         "divided_attention_general.cu"}
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
        "import profile_torch_flash, profile_torch_taskqa\n"
        "import profile_torch_cls_row, profile_torch_kernels\n"
        "import profile_torch_heads\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'egovlpv2_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('egovlpv2_torch')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    modules = set(proc.stdout.split())
    assert len(modules) >= 35
    assert {"egovlpv2_torch.parallel.mesh", "egovlpv2_torch.parallel.mp_worker",
            "egovlpv2_torch.parallel.collectives"} <= modules
