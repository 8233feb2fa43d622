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
the groups' partials in a second launch: their plain versions are held to
row 0 of the same TPU kernels, and K10's launch geometry (a pure function)
is checked at every head dim it takes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import divided as jdiv
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops.divided import (cls_row_partials_reference,
                                        divided_attention,
                                        divided_attention_backward_reference,
                                        merge_cls_partials_reference)

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
