"""egovlpv2_torch.ops against egovlpv2_tpu.ops on the CPU: the plain
divided attention and the plain LayerNorm (forward and backward) against
the JAX Pallas kernels (interpret mode), and `attend` / `layernorm`
against their JAX versions."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import attention as jattn
from egovlpv2_tpu.ops import divided as jdiv
from egovlpv2_tpu.ops import layernorm as jln
from egovlpv2_torch.ops import attention as tattn
from egovlpv2_torch.ops import layernorm as tln
from egovlpv2_torch.ops.divided import divided_attention

torch.set_num_threads(2)


@pytest.mark.parametrize("axis, case", [
    # (B, F, N, H, Dh): the packed frame-block space branch and the
    # frame-pair time branch (S=65), and the patch-major time window
    # (F=16, S=1601) of the JAX kernel.
    ("space", (2, 4, 16, 2, 64)),
    ("time", (2, 4, 16, 2, 64)),
    ("time", (1, 16, 100, 2, 64)),
])
def test_divided_attention_matches_jax_pallas(axis, case):
    b, f, n, h, dh = case
    qkv = np.random.RandomState(0).randn(b, 1 + f * n, 3, h, dh).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jdiv.divided_attention(jnp.asarray(qkv), scale=dh ** -0.5,
                                     axis=axis, num_frames=f, impl="pallas")
    got = divided_attention(torch.from_numpy(qkv), scale=dh ** -0.5,
                            axis=axis, num_frames=f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attend_with_padding_mask_matches_jax(dtype, tol):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 3, 7, 16).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 7), np.int32)
    mask[0, 4:] = 0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jattn.attend(*(jnp.asarray(x, jd) for x in (q, k, v)), scale=0.25,
                       bias=jattn.make_additive_mask(jnp.asarray(mask)))
    got = tattn.attend(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                       scale=0.25,
                       bias=tattn.make_additive_mask(torch.from_numpy(mask)))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_mask_and_head_layout_match_jax():
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        tattn.make_additive_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jattn.make_additive_mask(jnp.asarray(mask))))
    x = np.random.RandomState(2).randn(2, 5, 12).astype(np.float32)
    split = tattn.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(split.numpy(),
                                  np.asarray(jattn.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tattn.merge_heads(split).numpy(), x)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_layernorm_matches_jax(dtype, tol):
    rs = np.random.RandomState(3)
    # an offset mean makes E[x^2] - E[x]^2 differ from the two-pass variance
    x = (rs.randn(4, 9, 32) * 0.5 + 3.0).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(32)).astype(np.float32)
    bias = (0.1 * rs.randn(32)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jln.layernorm(jnp.asarray(x, jd), jnp.asarray(scale),
                        jnp.asarray(bias), eps=1e-6, impl="xla")
    got = tln.layernorm(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                        torch.from_numpy(bias), eps=1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    module = tln.LayerNorm(32, eps=1e-6, dtype=td)
    module.weight.data = torch.from_numpy(scale)
    module.bias.data = torch.from_numpy(bias)
    torch.testing.assert_close(module(torch.from_numpy(x)), got)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rows", [300, 7])  # 300: a partial last row tile
@pytest.mark.parametrize("d", [128, 256, 768])  # 768: the models' width
def test_plain_layernorm_matches_jax_pallas(d, rows, dtype, tol):
    """`layernorm_reference` and `layernorm_backward_reference` against the
    JAX package's Pallas LN kernels, forward and `jax.vjp`. Tolerance, of
    max |reference| of each tensor: 1e-5 in f32 (row and column sums in
    another order), 2e-2 in bf16 (one rounding step of y or dx where the
    f32 values differ in their last bits); dscale and dbias are f32 on
    both sides, sums of 300 products: 1e-5 in f32, 1e-3 from bf16 inputs."""
    rs = np.random.RandomState(rows + d)
    x = (rs.randn(rows, d) * 0.5 + 1.0).astype(np.float32)
    g = rs.randn(rows, d).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref_y, vjp = jax.vjp(
            lambda x, s, b: jln.layernorm(x, s, b, eps=1e-5, impl="pallas"),
            jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias))
        ref = (ref_y, *vjp(jnp.asarray(g, jd)))
    tx, tg = torch.from_numpy(x).to(td), torch.from_numpy(g).to(td)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got = (tln.layernorm_reference(tx, ts, tb, eps=1e-5),
           *tln.layernorm_backward_reference(tx, ts, tg, 1e-5))
    sum_tol = 1e-5 if dtype == "float32" else 1e-3
    for name, a, r, t in zip(("y", "dx", "dscale", "dbias"), got, ref,
                             (tol, tol, sum_tol, sum_tol)):
        r = np.asarray(r.astype(jnp.float32))
        assert a.shape == r.shape, name
        assert a.dtype == (td if name in ("y", "dx") else torch.float32), name
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=t * np.abs(r).max(), err_msg=name)
