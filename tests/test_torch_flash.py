"""The fused attention of egovlpv2_torch (`ops/flash.py`, `ops/attention.py`)
against egovlpv2_tpu on the CPU, float32, inputs from numpy seeds.

The JAX function reaches its Pallas kernel in interpret mode
(`pltpu.force_tpu_interpret_mode`) at lengths of 32 and above; below, the
JAX package hands the call to XLA, so the port is held against
`attend(impl="xla")` there. On CPU tensors the port takes the kernel's plain
version; the CUDA kernel itself is held against that version by the `gpu`
tests of `tests/test_torch_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import attention as jattn
from egovlpv2_torch.ops import _kernels, flash
from egovlpv2_torch.ops import attention as tattn

torch.set_num_threads(2)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _qkv(seed, qshape, sk):
    rs = np.random.RandomState(seed)
    kshape = qshape[:-2] + (sk, qshape[-1])
    return (rs.randn(*qshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32))


def _mask(seed, b, sk):
    mask = (np.random.RandomState(seed).rand(b, sk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return mask


def _jax_pallas(q, k, v, bias=None):
    with pltpu.force_tpu_interpret_mode():
        return jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale=q.shape[-1] ** -0.5, bias=bias,
                            impl="pallas")


@pytest.mark.parametrize("qshape, sk", [
    ((2, 3, 2, 37, 40), 37),  # many leading axes, odd lengths
    ((2, 2, 33, 64), 33),
    ((2, 2, 196, 64), 197),   # space attention with the CLS key
])
def test_flash_attention_matches_jax_pallas_forward(qshape, sk):
    q, k, v = _qkv(0, qshape, sk)
    ref = _jax_pallas(q, k, v)
    got = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                scale=qshape[-1] ** -0.5)
    assert got.shape == qshape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_flash_attention_with_padding_bias_matches_jax_pallas():
    b, h, sq, sk, dh = 2, 2, 33, 40, 8
    q, k, v = _qkv(1, (b, h, sq, dh), sk)
    mask = _mask(1, b, sk)
    jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                             (b, h, 1, sk))
    ref = _jax_pallas(q, k, v, bias=jbias)
    # the port takes the unexpanded [B, 1, 1, Sk] mask and the expanded one
    tbias = tattn.make_additive_mask(torch.from_numpy(mask))
    for bias in (tbias, tbias.expand(b, h, 1, sk)):
        got = tattn.attend(*(torch.from_numpy(x) for x in (q, k, v)),
                           scale=dh ** -0.5, bias=bias)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_gradients_match_jax_pallas(with_bias):
    b, h, sq, sk, dh = 2, 2, 40, 33, 8
    q, k, v = _qkv(2, (b, h, sq, dh), sk)
    mask = _mask(3, b, sk)
    jbias = tbias = None
    if with_bias:
        jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                                 (b, h, 1, sk))
        tbias = tattn.make_additive_mask(torch.from_numpy(mask))

    def loss(q, k, v):
        out = jattn.attend(q, k, v, scale=dh ** -0.5, bias=jbias,
                           impl="pallas")
        return jnp.sum(out * out)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention(*leaves, scale=dh ** -0.5, bias=tbias)
    (out * out).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   **GRAD_TOL)


@pytest.mark.parametrize("sq, sk, masked", [
    (15, 15, True),    # text self-attention at pretrain's 15 tokens
    (30, 30, True),    # and at the fine-tunes' 30
    (50, 15, True),    # i2t: video queries over the text keys
    (15, 50, False),   # t2i: text queries over the video keys, no mask
])
def test_attend_matches_jax_xla_at_short_lengths_and_strided_views(sq, sk,
                                                                  masked):
    """Below 32 tokens the JAX package runs XLA; the port runs the fused
    path at every length. q is a `split_heads` view of a [B, S, H*Dh]
    projection, k and v are slices of one packed [B, Sk, 2, H, Dh]
    projection, as the models hand them over; forward and gradients."""
    b, h, dh = 2, 3, 16
    rs = np.random.RandomState(sq + sk)
    qp = rs.randn(b, sq, h * dh).astype(np.float32)
    kvp = rs.randn(b, sk, 2, h, dh).astype(np.float32)
    g = rs.randn(b, h, sq, dh).astype(np.float32)
    mask = _mask(4, b, sk)
    mask[1] = 1

    def jfn(qp, kvp):
        kv = kvp.transpose(2, 0, 3, 1, 4)
        bias = jattn.make_additive_mask(jnp.asarray(mask)) if masked else None
        return jattn.attend(jattn.split_heads(qp, h), kv[0], kv[1],
                            scale=dh ** -0.5, bias=bias, impl="xla")

    ref, vjp = jax.vjp(jfn, jnp.asarray(qp), jnp.asarray(kvp))
    ref_grads = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qp).requires_grad_(True)
    tkv = torch.from_numpy(kvp).requires_grad_(True)
    kv = tkv.permute(2, 0, 3, 1, 4)
    q, k, v = tattn.split_heads(tq, h), kv[0], kv[1]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    bias = tattn.make_additive_mask(torch.from_numpy(mask)) if masked else None
    got = tattn.attend(q, k, v, scale=dh ** -0.5, bias=bias)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD_TOL)
    for leaf, r in zip((tq, tkv), ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **GRAD_TOL)


def test_fully_masked_row_is_uniform_as_jax_attend_gives_it():
    """The mask is additive -1e9, not -inf: a row whose keys are all masked
    attends all of them alike."""
    q, k, v = _qkv(5, (2, 2, 6, 8), 9)
    mask = np.ones((2, 9), np.int32)
    mask[0] = 0
    ref = jattn.attend(*(jnp.asarray(x) for x in (q, k, v)), scale=0.3,
                       bias=jattn.make_additive_mask(jnp.asarray(mask)))
    got = tattn.attend(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3,
                       bias=tattn.make_additive_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(v[0].mean(axis=-2, keepdims=True),
                                        (2, 6, 8)), **FWD_TOL)


def test_attend_takes_the_fused_path_unless_probabilities_are_dropped(
        monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, (2, 2, 5, 8), 7))
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    before = dict(_kernels.launch_counts)
    fused = tattn.attend(q, k, v, scale=0.3)
    assert len(calls) == 1 and calls[0]["scale"] == 0.3
    dropped = tattn.attend(q, k, v, scale=0.3, prob_dropout=0.5,
                           generator=torch.Generator().manual_seed(0))
    assert len(calls) == 1  # the plain code, not the fused path
    assert not torch.equal(fused, dropped)
    # on a CPU tensor the fused path is the kernel's plain version, bit for
    # bit, and launches nothing
    assert torch.equal(fused, flash.flash_attention_reference(q, k, v,
                                                              scale=0.3))
    torch.testing.assert_close(fused, tattn.attend_plain(q, k, v, scale=0.3))
    assert _kernels.launch_counts == before


def test_flash_attention_rejects_what_it_cannot_take():
    q = torch.zeros(2, 3, 5, 16)
    k = torch.zeros(2, 3, 7, 16)
    with pytest.raises(ValueError, match=r"\(2, 3, 5, 7\)"):  # varies over Sq
        flash.flash_attention(q, k, k, scale=1.0, bias=torch.zeros(2, 3, 5, 7))
    with pytest.raises(ValueError, match=r"\(2, 1, 1, 9\)"):  # other Sk
        flash.flash_attention(q, k, k, scale=1.0, bias=torch.zeros(2, 1, 1, 9))
    with pytest.raises(ValueError, match=r"\(2, 3, 5, 12\)"):  # Dh = 12
        flash.flash_attention(q[..., :12], k[..., :12], k[..., :12], scale=1.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 5, 136\)"):  # Dh = 136
        flash.flash_attention(torch.zeros(2, 3, 5, 136),
                              torch.zeros(2, 3, 7, 136),
                              torch.zeros(2, 3, 7, 136), scale=1.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 7, 8\)"):  # v's width
        flash.flash_attention(q, k, k[..., :8], scale=1.0)
    with pytest.raises(ValueError, match="float16"):
        flash.flash_attention(q.half(), k.half(), k.half(), scale=1.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 0, 16\)"):  # no key
        flash.flash_attention(q, k[:, :, :0], k[:, :, :0], scale=1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                              scale=1.0)


