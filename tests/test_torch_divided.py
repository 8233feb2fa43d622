"""The port's divided attention (the plain version, which K10/K11 are held
to on the card) against the three TPU kernels that K10/K11 replace, run as
the JAX package's own tests run them, in interpret mode, f32: forward
within 2e-5 and the gradient of sum(out * cotangent) within 5e-5 of max
|reference| (f32 sums in another order).

  * rows 3 and 4, dense: `_fwd_kernel` / `_bwd_kernel` over [block_q, S]
    tiles with `_mask_bias`, reached when the heads cannot be lane-packed;
  * rows 3 and 4, frame-block: the same kernels' `_space_fb_fwd` /
    `_space_fb_bwd` branch, reached on the space axis above
    `_SPACE_WINDOW_MIN_S` (lowered here by monkeypatch);
  * row 1d: the dense masked branch of `_packed_fwd_kernel` /
    `_packed_bwd_kernel`, reached on the time axis at F > 8 with S <= 1536.

K10 splits the CLS query row across the groups of its tiling and merges
the groups' partials in a second launch, and writes each row's
log-sum-exp for K11; K11 splits row 0's gradient the same way (the CLS
query's dq over each group's keys, the CLS key's dk and dv from each
group's queries) and merges it in a third launch. Their plain versions are
held to the JAX package (row 0 of the TPU kernels' output and of their
backward; the log-sum-exp of the logits under the TPU kernels' group
bias), and the launch geometry of K10 and of K11 (pure functions) is
checked at every head dim they take.

K5, the bf16 time-axis backward of the patch rows, takes in its
tensor-core form whole patch columns, a block `cols` of them: the plain
version of that block (`time_column_grad_reference`, P and dS rounded as
the kernel rounds them) and K6's plain version after it are held to the
TPU kernels K5 replaces on the time axis, the frame-pair branch at F <= 8
and the patch-major window branch at F > 8; its launch geometry (a pure
function) is checked at every head dim K5 takes.

K2, the bf16 time-axis forward of the patch rows, takes in its
tensor-core form whole patch columns too: the plain version of its block
(`time_column_reference`, the softmax's numerator rounded as the kernel
rounds it) is held to the same TPU kernels' forward, and its launch
geometry (a pure function) is checked at every head dim and at the frame
counts on both sides of each edge.

K3 and K6, the bf16 kernels of the CLS row, split the CLS query's keys
into runs of `cls_row_geometry`: K3 writes each run's partial and merges
them into row 0 and its log-sum-exp lse0; K6 reads lse0 and the output's
row 0 and makes one pass over the keys. Their plain versions are held to
the packed TPU kernel's all-heads CLS pass: its forward through
`_packed_fwd_pallas` in interpret mode (row 0 is `_cls_row_fwd_allh`'s),
its backward `_cls_dense_bwd_allh` itself.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import divided as jdiv
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops.divided import (cls_grad_partials_reference,
                                        cls_row_partials_reference,
                                        cls_run_grad_reference,
                                        cls_run_partials_reference,
                                        divided_attention,
                                        divided_attention_backward_reference,
                                        merge_cls_grad_reference,
                                        merge_cls_partials_reference,
                                        merge_cls_run_partials_reference,
                                        row_lse_reference,
                                        time_column_grad_reference,
                                        time_column_reference)

torch.set_num_threads(2)

CASES = {
    # name: (axis, B, F, N, H, Dh, window_min_s or None)
    "rows34_dense_space": ("space", 2, 2, 16, 2, 16, None),
    "rows34_dense_time": ("time", 2, 2, 16, 2, 16, None),
    "rows34_frame_block": ("space", 2, 3, 16, 2, 64, 32),
    "row1d_packed_dense_time": ("time", 1, 9, 2, 2, 64, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_divided_attention_matches_the_tpu_kernels(name, monkeypatch):
    axis, b, f, n, h, dh, window_min = CASES[name]
    if window_min is not None:
        monkeypatch.setattr(jdiv, "_SPACE_WINDOW_MIN_S", window_min)
    s = 1 + f * n
    scale = dh ** -0.5
    # the branch the JAX package takes at this shape, f32
    packed = jdiv._packed_heads(h, dh, s, 4, budget=jdiv._BWD_BUDGET)
    if name.startswith("rows34"):
        assert packed is None or jdiv._windowed(axis, s)
        assert jdiv._windowed(axis, s) == (window_min is not None)
    else:
        assert packed is not None and f > 8 and s <= jdiv._PACKED_MAX_S
    rs = np.random.RandomState(7)
    qkv = rs.randn(b, s, 3, h, dh).astype(np.float32)
    ct = rs.randn(b, s, h, dh).astype(np.float32)

    def loss(x):
        out = jdiv.divided_attention(x, scale=scale, axis=axis, num_frames=f,
                                     impl="pallas")
        return jnp.sum(out * jnp.asarray(ct)), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), ref_grad = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(qkv))
    ref, ref_grad = np.asarray(ref), np.asarray(ref_grad)
    got = divided_attention(torch.from_numpy(qkv), scale=scale, axis=axis,
                            num_frames=f)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    grad = divided_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(ct), scale=scale, axis=axis,
        num_frames=f)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0,
                               atol=5e-5 * np.abs(ref_grad).max())


# CASES and a head dim that is not a multiple of 4 or 8, on both axes
CLS_CASES = {**CASES,
             "dh12_space": ("space", 2, 3, 10, 2, 12, None),
             "dh12_time": ("time", 2, 3, 10, 2, 12, None)}


@pytest.mark.parametrize("name", list(CLS_CASES))
def test_cls_row_partials_merge_to_the_tpu_kernels_row0(name, monkeypatch):
    """The plain versions of K10's CLS partials (one a group) and of their
    merge give row 0 of the TPU kernels' output within 2e-5 of max
    |reference| (f32 sums in another order)."""
    axis, b, f, n, h, dh, window_min = CLS_CASES[name]
    if window_min is not None:
        monkeypatch.setattr(jdiv, "_SPACE_WINDOW_MIN_S", window_min)
    s = 1 + f * n
    scale = dh ** -0.5
    qkv = np.random.RandomState(11).randn(b, s, 3, h, dh).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdiv.divided_attention(
            jnp.asarray(qkv), scale=scale, axis=axis, num_frames=f,
            impl="pallas"))[:, 0]  # [B, H, Dh]
    partials = cls_row_partials_reference(torch.from_numpy(qkv), scale=scale,
                                          axis=axis, num_frames=f)
    geo = _kernels.general_fwd_geometry(torch.float32, dh, s, f, axis)
    assert partials.shape == (b, h, geo.parts, dh + 2)
    got = merge_cls_partials_reference(partials)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("s, frames", [(785, 4), (1177, 6)])
def test_general_fwd_geometry(dtype, axis, s, frames):
    """At every head dim K10 takes: the block's shared memory fits Hopper's
    232,448 bytes (by the kernel's own layout: Q, the K/V ring, P); the
    groups cover the patch rows without an empty one, each group's rows
    and the CLS row fit its query tiles, and `parts` is the scratch's parts
    axis; rows are padded to an odd number of 16-byte words."""
    n = (s - 1) // frames
    for dh in range(1, _kernels.GENERAL_MAX_DH + 1):
        geo = _kernels.general_fwd_geometry(dtype, dh, s, frames, axis)
        bq, bk = geo.block_q, geo.block_k
        assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX == 232448
        assert geo.shared_bytes == 4 * (bq * geo.ld + 2 * geo.stages * bk
                                        * geo.ld + bq * (bk + 16))
        assert geo.ld >= dh and geo.ld % 4 == 0 and (geo.ld // 4) % 2 == 1
        assert geo.stages in (1, 2)
        if axis == "space":
            assert (geo.cols, geo.parts) == (n, frames)
            rows = n
        else:
            assert (geo.parts - 1) * geo.cols < n <= geo.parts * geo.cols
            rows = frames * geo.cols
            assert rows + 1 <= bq  # one query tile and one key tile a group
        assert (geo.query_tiles - 1) * bq < rows + 1 <= geo.query_tiles * bq
        assert geo.stages == 2 or rows + 1 <= bk \
            or 4 * (bq * geo.ld + 4 * bk * geo.ld + bq * (bk + 16)) \
            > _kernels.SHARED_BYTES_MAX
        qkv = torch.empty((2, s, 3, 3, dh), dtype=dtype, device="meta")
        scratch = _kernels.general_fwd_scratch(qkv, geo)
        assert tuple(scratch.shape) == (2, 3, geo.parts, dh + 2)
        assert scratch.dtype == torch.float32


@pytest.mark.parametrize("name", list(CLS_CASES))
def test_row_lse_reference_matches_the_masked_logits(name):
    """The plain version of K10's lse (which K11 reads): each row's
    log-sum-exp, within 2e-5 of max |reference| of the log-sum-exp in JAX
    of the logits scale * q.k under the TPU kernels' group bias
    `_mask_bias` (-1e9 off the group; f32 sums in another order)."""
    axis, b, f, n, h, dh, _ = CLS_CASES[name]
    s = 1 + f * n
    scale = dh ** -0.5
    qkv = np.random.RandomState(13).randn(b, s, 3, h, dh).astype(np.float32)
    logits = jnp.einsum("bihd,bjhd->bhij", jnp.asarray(qkv[:, :, 0]),
                        jnp.asarray(qkv[:, :, 1]), precision="highest")
    logits = logits * scale + jdiv._mask_bias(0, s, s, axis, n)
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1))  # [B, H, S]
    got = row_lse_reference(torch.from_numpy(qkv), scale=scale, axis=axis,
                            num_frames=f)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(CLS_CASES))
def test_cls_grad_partials_merge_to_the_tpu_kernels_row0(name, monkeypatch):
    """The plain versions of K11's per-group partials of row 0 (the CLS
    query's dq over each group's keys; the CLS key's dk and dv from each
    group's queries), summed in group order, give row 0 of the TPU
    kernels' backward (`jax.vjp` of `divided_attention`, interpret mode)
    within 2e-5 of its max |reference| (f32 sums in another order)."""
    axis, b, f, n, h, dh, window_min = CLS_CASES[name]
    if window_min is not None:
        monkeypatch.setattr(jdiv, "_SPACE_WINDOW_MIN_S", window_min)
    s = 1 + f * n
    scale = dh ** -0.5
    rs = np.random.RandomState(17)
    qkv = rs.randn(b, s, 3, h, dh).astype(np.float32)
    ct = rs.randn(b, s, h, dh).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x: jdiv.divided_attention(
            x, scale=scale, axis=axis, num_frames=f, impl="pallas"),
            jnp.asarray(qkv))
        (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)[:, 0]  # [B, 3, H, Dh]
    partials = cls_grad_partials_reference(
        torch.from_numpy(qkv), torch.from_numpy(ct), scale=scale, axis=axis,
        num_frames=f)
    geo = _kernels.general_bwd_geometry(torch.float32, dh, s, f, axis)
    assert partials.shape == (b, h, geo.parts, 3, dh)
    got = merge_cls_grad_reference(partials, scale=scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("s, frames", [(785, 4), (1177, 6)])
def test_general_bwd_geometry(dtype, axis, s, frames):
    """At every head dim K11 takes: K10's groups, row stride and 64-unit
    tiles, which cover each group's rows and the CLS row; each pass's block
    fits Hopper's 232,448 bytes by the kernel's own layout (two resident
    64-row tiles, two streamed tiles a stage, one score tile in the query
    pass; two in the key pass, and the streamed rows' lse and delta a
    stage); streamed tiles of 64 rows, or of 32 only
    where 64 do not fit (head dims above 128, where the kernel has them); a
    second stage only where a group has two streamed tiles, and never at
    the cost of a second block an SM (two at the EgoTaskQA head dim, 64);
    the scratch's shapes."""
    n = (s - 1) // frames
    two, most = _kernels.SHARED_BYTES_TWO, _kernels.SHARED_BYTES_MAX
    assert (two, most) == (115712, 232448)
    for dh in range(1, _kernels.GENERAL_MAX_DH + 1):
        fwd = _kernels.general_fwd_geometry(dtype, dh, s, frames, axis)
        geo = _kernels.general_bwd_geometry(dtype, dh, s, frames, axis)
        assert (geo.block_q, geo.cols, geo.parts, geo.tiles, geo.ld) == (
            64, fwd.cols, fwd.parts, fwd.query_tiles, fwd.ld)
        units = 1 + (n if axis == "space" else frames * geo.cols)
        assert (geo.tiles - 1) * 64 < units <= geo.tiles * 64
        for scores, p in ((1, geo.query_pass), (2, geo.key_pass)):
            def layout(rows, stages):
                return 4 * (2 * 64 * geo.ld + 2 * stages * rows * geo.ld
                            + scores * 64 * (rows + 16)
                            + (scores - 1) * 2 * stages * rows)
            assert p.shared_bytes == layout(p.rows, p.stages) <= most
            assert p.rows == 64 or (p.rows == 32 and dh > 128
                                    and layout(64, 1) > most)
            assert p.stages == 1 or (p.stages == 2 and -(-units // p.rows) > 1)
            if layout(p.rows, 1) <= two:
                assert p.shared_bytes <= two
        if dh == 64:
            assert max(geo.query_pass.shared_bytes,
                       geo.key_pass.shared_bytes) <= two
        qkv = torch.empty((2, s, 3, 3, dh), dtype=dtype, device="meta")
        delta, cls = _kernels.general_bwd_scratch(qkv, geo)
        assert tuple(delta.shape) == (2, 3, s)
        assert tuple(cls.shape) == (2, 3, geo.parts, 3, dh)
        assert delta.dtype == cls.dtype == torch.float32


# The packed TPU kernel's all-heads CLS pass: (axis, B, F, N, H, Dh, heads a
# program hp, with hp * Dh a multiple of 128). In f32 a run of
# `cls_row_geometry` is 128 keys at Dh=64, 256 at Dh=32 and 512 at Dh=16:
# S under one run, S past a run but not a multiple of it, and a last run of
# one key.
ALLH_CASES = {
    "space_one_run": ("space", 2, 2, 16, 2, 64, 2),
    "space_three_runs": ("space", 1, 3, 100, 2, 64, 2),
    "time_last_run_one_key": ("time", 1, 4, 64, 4, 32, 4),
    "space_dh16": ("space", 1, 2, 200, 8, 16, 8),
}


def _allh_inputs(name, seed):
    axis, b, f, n, h, dh, hp = ALLH_CASES[name]
    s = 1 + f * n
    rs = np.random.RandomState(seed)
    qkv = rs.randn(b, s, 3, h, dh).astype(np.float32)
    ct = rs.randn(b, s, h, dh).astype(np.float32)
    return axis, f, h, dh, hp, s, dh ** -0.5, qkv, ct


@pytest.mark.parametrize("name", list(ALLH_CASES))
def test_cls_run_partials_merge_to_the_packed_kernels_row0(name):
    """The plain versions of K3's partials (one a run of keys) and of their
    merge give row 0 of `_packed_fwd_pallas` (interpret mode), which the
    all-heads pass `_cls_row_fwd_allh` writes on this branch, within 2e-5
    of max |reference| (f32 sums in another order)."""
    axis, f, h, dh, hp, s, scale, qkv, _ = _allh_inputs(name, 19)
    assert (hp * dh) % 128 == 0 and h % hp == 0
    # the branches of `_packed_fwd_kernel` that run `_cls_row_fwd_allh`
    assert (jdiv._space_fb(axis, s) and jdiv._SPACE_CLS_ALLH) or (
        jdiv._time_fp(axis, f) and jdiv._TIME_FP_MXU)
    b = qkv.shape[0]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdiv._packed_fwd_pallas(
            jnp.asarray(qkv.reshape(b, s, -1)), scale, axis, f, h, dh, hp))
    ref = ref[:, 0].reshape(b, h, dh)
    partials = cls_run_partials_reference(torch.from_numpy(qkv), scale=scale)
    geo = _kernels.cls_row_geometry(torch.float32, dh, s)
    assert partials.shape == (b, h, geo.parts, dh + 2)
    got, _ = merge_cls_run_partials_reference(partials)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(ALLH_CASES))
def test_cls_run_lse_matches_row_lse_reference(name):
    """lse0, merged from K3's partials, is row 0 of `row_lse_reference`
    (the log-sum-exp of the CLS query's logits over all S keys) within
    2e-5 of max |reference|."""
    axis, f, h, dh, hp, s, scale, qkv, _ = _allh_inputs(name, 23)
    x = torch.from_numpy(qkv)
    _, lse0 = merge_cls_run_partials_reference(
        cls_run_partials_reference(x, scale=scale))
    ref = row_lse_reference(x, scale=scale, axis=axis, num_frames=f)[:, :, 0]
    assert lse0.shape == ref.shape == (qkv.shape[0], h)
    np.testing.assert_allclose(lse0.numpy(), ref.numpy(), rtol=0,
                               atol=2e-5 * ref.abs().max().item())


@pytest.mark.parametrize("name", list(ALLH_CASES))
def test_cls_run_grad_matches_cls_dense_bwd_allh(name):
    """The plain version of K6's one pass, from the output row and lse0 of
    K3's plain version (as the autograd Function hands them over), gives
    `_cls_dense_bwd_allh`'s dq0 (scale times the runs' partials, summed in
    order), dkd and dvd (the CLS query's share of every key's dk and dv)
    within 5e-5 of max |reference| of each (f32 sums in another order)."""
    axis, f, h, dh, hp, s, scale, qkv, ct = _allh_inputs(name, 29)
    b = qkv.shape[0]
    x, g = torch.from_numpy(qkv), torch.from_numpy(ct)
    out0, lse0 = merge_cls_run_partials_reference(
        cls_run_partials_reference(x, scale=scale))
    dq_parts, dkd, dvd = cls_run_grad_reference(x, g, out0, lse0, scale=scale)
    geo = _kernels.cls_row_geometry(torch.float32, dh, s)
    assert dq_parts.shape == (b, h, geo.parts, dh)
    dq0 = scale * dq_parts.sum(2)  # [B, H, Dh]
    w = hp * dh
    for bi in range(b):
        for grp in range(h // hp):
            heads = slice(grp * hp, (grp + 1) * hp)
            q, k, v = (jnp.asarray(qkv[bi:bi + 1, :, c, heads].reshape(1, s, w))
                       for c in range(3))
            ref_dq, ref_dk, ref_dv = (np.asarray(t) for t in jdiv._cls_dense_bwd_allh(
                q, k, v, jnp.asarray(ct[bi:bi + 1, :, heads].reshape(1, s, w)),
                scale, hp, dh))
            for got, ref in ((dq0[bi, heads].reshape(1, w), ref_dq),
                             (dkd[bi, :, heads].reshape(s, w), ref_dk),
                             (dvd[bi, :, heads].reshape(s, w), ref_dv)):
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=5e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 785, 981, 3137, 6273])
def test_cls_row_geometry(dtype, s):
    """At every head dim K3/K6 take (8 to 128 in steps of 8): lanes a key
    cover the head dim at 8 elements a lane, as a power of two that divides
    a warp; a row group takes 4 keys (the kernels' compiled count); a run is
    those keys times the block's row groups, 128 at the slice's Dh=64; the
    runs cover S with the last one non-empty; S shorter than one run comes
    out as one part."""
    for dh in range(8, _kernels.CLS_ROW_MAX_DH + 1, 8):
        geo = _kernels.cls_row_geometry(dtype, dh, s)
        assert geo.group * 8 >= dh > geo.group * 4
        assert geo.group in (1, 2, 4, 8, 16)
        assert geo.keys == 4
        assert geo.run == geo.keys * _kernels.CLS_ROW_THREADS // geo.group
        assert (geo.parts - 1) * geo.run < s <= geo.parts * geo.run
        if s < geo.run:
            assert geo.parts == 1
    assert _kernels.CLS_ROW_THREADS == 256
    assert _kernels.cls_row_geometry(dtype, 64, s).run == 128
    assert _kernels.cls_row_geometry(dtype, 8, 785).parts == 1  # S < a run
    for bad in (4, 12, 136):
        with pytest.raises(ValueError, match="head dim"):
            _kernels.cls_row_geometry(dtype, bad, s)


# The TPU kernels K5 replaces on the time axis, f32, lane-packed heads:
# (B, F, N, H, Dh, _PACKED_MAX_S or None). At F <= 8 the frame-pair branch
# `_packed_bwd_time_fp_mxu`; at F > 8 the patch-major window branch of
# `_packed_bwd_kernel` (`_space_fb_bwd` over `_pm_window`), which the JAX
# package reaches above `_PACKED_MAX_S` (lowered here by monkeypatch).
TIME_CASES = {
    "frame_pair_f4": (2, 4, 16, 2, 64, None),
    "frame_pair_f5_dh32": (1, 5, 9, 4, 32, None),
    "patch_major_f9": (1, 9, 8, 2, 64, 64),
    "patch_major_f16_dh32": (1, 16, 6, 4, 32, 64),
}


@pytest.mark.parametrize("name", list(TIME_CASES))
def test_time_column_grad_matches_the_tpu_kernels(name, monkeypatch):
    """The plain version of K5's tensor-core block (dq, dk, dv of the patch
    rows and the blocks' partials of the CLS key's dk/dv), then K6's plain
    version from K3's (the CLS query's share of every dk/dv row and its dq),
    give the TPU kernels' backward (`jax.vjp` of `divided_attention`,
    interpret mode) within 2e-5 of max |reference| (f32 sums in another
    order): the patch rows, and row 0 as the summed partials plus the CLS
    query's share."""
    b, f, n, h, dh, packed_max = TIME_CASES[name]
    if packed_max is not None:
        monkeypatch.setattr(jdiv, "_PACKED_MAX_S", packed_max)
    s = 1 + f * n
    scale = dh ** -0.5
    if packed_max is None:  # the frame-pair branch
        assert jdiv._time_fp("time", f) and s <= jdiv._PACKED_MAX_S
        budget = jdiv._BWD_BUDGET
    else:  # the patch-major window branch
        assert jdiv._time_pm("time", s, f)
        budget = jdiv._LONG_BUDGET
    assert jdiv._packed_heads(h, dh, s, 4, budget=budget) is not None
    rs = np.random.RandomState(31)
    qkv = rs.randn(b, s, 3, h, dh).astype(np.float32)
    ct = rs.randn(b, s, h, dh).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x: jdiv.divided_attention(
            x, scale=scale, axis="time", num_frames=f, impl="pallas"),
            jnp.asarray(qkv))
        (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    x, g = torch.from_numpy(qkv), torch.from_numpy(ct)
    dqkv, cls_part = time_column_grad_reference(x, g, scale=scale,
                                                num_frames=f)
    geo = _kernels.time_bwd_geometry(torch.bfloat16, dh, s, f)
    assert geo.form == "tensor_cores"
    assert cls_part.shape == (b, h, geo.parts, 2, dh)
    assert not dqkv[:, 0].any()  # K5 leaves row 0 to K6
    out0, lse0 = merge_cls_run_partials_reference(
        cls_run_partials_reference(x, scale=scale))
    dq_parts, dkd, dvd = cls_run_grad_reference(x, g, out0, lse0, scale=scale)
    got = dqkv.clone()
    got[:, :, 1] += dkd
    got[:, :, 2] += dvd
    got[:, 0, 0] = scale * dq_parts.sum(2)
    got[:, 0, 1:] += cls_part.sum(2).permute(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s, frames", [(785, 4), (3137, 16), (6273, 32),
                                       (981, 5)])
def test_time_bwd_geometry(dtype, s, frames):
    """At every head dim K5 takes (8 to 128 in steps of 8): the form (the
    tensor cores for bf16 at Dh 16, 32, 48, 64, else the grouped passes); the blocks' runs of patch rows in
    column-major order cover every patch row once, whole columns in the
    tensor-core form; a tensor-core block's shared memory, by the kernel's
    own layout (K, V, Q, G at a pitch of Dh + 8 bf16, P and dS at KP + 8,
    the f32 [2, Dh] CLS sums), fits Hopper's 232,448 bytes, its tiles hold
    the F + 1 keys and F queries; `parts` is the parts axis of the
    `cls_part` that `attention_bwd_scratch` allocates. The edges: F=63 is
    the last frame count on the tensor cores, F=64 the first off."""
    n = (s - 1) // frames
    for dh in range(8, 129, 8):
        geo = _kernels.time_bwd_geometry(dtype, dh, s, frames)
        on = dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 64
        assert geo.form == ("tensor_cores" if on else "grouped")
        covered = np.zeros(s - 1, dtype=int)
        for part in range(geo.parts):
            idx = np.arange(part * geo.rows, min((part + 1) * geo.rows, s - 1))
            covered[(idx % frames) * n + idx // frames] += 1
        assert (covered == 1).all()
        assert (geo.parts - 1) * geo.rows < s - 1 <= geo.parts * geo.rows
        if on:
            kp, qp = 16 * geo.key_tiles, 16 * geo.query_tiles
            assert kp - 16 < frames + 1 <= kp and qp - 16 < frames <= qp
            assert geo.rows == geo.cols * frames
            layout = 2 * ((2 * kp + 2 * qp) * (dh + 8) + 2 * qp * (kp + 8)) \
                + 2 * dh * 4
            assert geo.shared_bytes == layout <= _kernels.SHARED_BYTES_MAX
        else:
            assert (geo.cols, geo.shared_bytes) == (None, 16384)
        qkv = torch.empty((2, s, 3 * 3 * dh), dtype=dtype, device="meta")
        stats, cls_part = _kernels.attention_bwd_scratch(
            qkv, num_heads=3, num_frames=frames, axis="time")
        assert tuple(stats.shape) == (2, 2, 3, s)
        assert tuple(cls_part.shape) == (2, 3, geo.parts, 2, dh)
    assert _kernels.SHARED_BYTES_MAX == 232448
    edge = {f: _kernels.time_bwd_geometry(torch.bfloat16, 64, 1 + 2 * f, f)
            for f in (63, 64)}
    assert (edge[63].form, edge[64].form) == ("tensor_cores", "grouped")
    assert edge[63].shared_bytes > 48 * 1024  # past the static limit


@pytest.mark.parametrize("name", list(TIME_CASES))
def test_time_column_matches_the_tpu_kernels(name, monkeypatch):
    """The plain version of K2's tensor-core block gives the TPU kernels'
    time-axis forward of the patch rows (`divided_attention`, interpret
    mode; the frame-pair branch at F <= 8, the patch-major window branch at
    F > 8) within 1e-5, f32 (sums in another order)."""
    b, f, n, h, dh, packed_max = TIME_CASES[name]
    if packed_max is not None:
        monkeypatch.setattr(jdiv, "_PACKED_MAX_S", packed_max)
    s = 1 + f * n
    scale = dh ** -0.5
    qkv = np.random.RandomState(37).randn(b, s, 3, h, dh).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdiv.divided_attention(
            jnp.asarray(qkv), scale=scale, axis="time", num_frames=f,
            impl="pallas"))
    got = time_column_reference(torch.from_numpy(qkv), scale=scale,
                                num_frames=f)
    assert got.shape == (b, s - 1, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[:, 1:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames", [1, 4, 5, 8, 16, 32, 63, 64])
def test_time_fwd_geometry(dtype, frames):
    """At every head dim K2 takes (8 to 128 in steps of 8) and N = 13
    patch columns: the form (the tensor cores for bf16 at Dh 16, 32, 48, 64
    up to TIME_FWD_MAX_F = 63 frames, else the grouped form); the blocks'
    runs of patch rows in column-major order cover every patch row once,
    whole columns in the tensor-core form, the last block short where the
    columns do not divide N; a tensor-core block (one warp) takes
    ceil(16 / F) columns, at least 16 query rows, its tiles hold the F + 1
    keys and F queries, and its shared memory, by the kernel's own layout
    (one buffer of K and V at 16 * key_tiles rows and Q at 16 * query_tiles,
    a pitch of Dh + 8 bf16), fits Hopper's 232,448 bytes."""
    n = 13
    s = 1 + frames * n
    for dh in range(8, 129, 8):
        geo = _kernels.time_fwd_geometry(dtype, dh, s, frames)
        on = dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 64 \
            and frames <= 63
        assert geo.form == ("tensor_cores" if on else "grouped")
        covered = np.zeros(s - 1, dtype=int)
        for part in range(geo.parts):
            idx = np.arange(part * geo.rows, min((part + 1) * geo.rows, s - 1))
            covered[(idx % frames) * n + idx // frames] += 1
        assert (covered == 1).all()
        assert (geo.parts - 1) * geo.rows < s - 1 <= geo.parts * geo.rows
        if on:
            assert geo.rows == geo.cols * frames
            assert geo.cols == -(-16 // frames) >= 1
            assert geo.parts == -(-n // geo.cols)
            if frames in (4, 5, 8):  # 4, 4 and 2 columns: the last block short
                assert n % geo.cols
            kp, qp = 16 * geo.key_tiles, 16 * geo.query_tiles
            assert kp - 16 < frames + 1 <= kp and qp - 16 < frames <= qp
            layout = 2 * (2 * kp + qp) * (dh + 8)
            assert geo.shared_bytes == layout <= _kernels.SHARED_BYTES_MAX
        else:
            assert geo.rows == 256 // _kernels.cls_row_geometry(
                dtype, dh, s).group
            assert (geo.cols, geo.key_tiles, geo.shared_bytes) == (None,) * 3
