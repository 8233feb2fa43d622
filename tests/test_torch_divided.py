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
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import divided as jdiv
from egovlpv2_torch.ops.divided import (divided_attention,
                                        divided_attention_backward_reference)

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
