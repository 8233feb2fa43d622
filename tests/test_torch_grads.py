"""Gradients of egovlpv2_torch against egovlpv2_tpu on the CPU, in f32: the
ops that hold a kernel (divided attention w.r.t. qkv), `attend` with a
dropout mask, LayerNorm, and the video block, text layer and towers in
training mode with every dropout rate at 0 (so both sides are
deterministic), w.r.t. inputs and every parameter.

Tolerance 1e-4 relative and absolute on gradients of O(1): both sides sum
in f32 in another order (XLA:CPU at 'highest' matmul precision, set by
conftest, against PyTorch's)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.core.config import (FusionConfig, TextEncoderConfig,
                                      VideoEncoderConfig)
from egovlpv2_tpu.models import text as jtext
from egovlpv2_tpu.models import video as jvideo
from egovlpv2_tpu.ops import attention as jattn
from egovlpv2_tpu.ops import divided as jdiv
from egovlpv2_tpu.ops import layernorm as jln
from egovlpv2_tpu.ops.attention import make_additive_mask as jmask
from egovlpv2_torch.models import text as ttext
from egovlpv2_torch.models import video as tvideo
from egovlpv2_torch.ops import attention as tattn
from egovlpv2_torch.ops import layernorm as tln
from egovlpv2_torch.ops.attention import make_additive_mask as tmask
from egovlpv2_torch.ops.divided import (divided_attention,
                                        divided_attention_backward_reference)
from egovlpv2_torch.weights import state_dict_from_flax
from torch_parity import load_flax, perturb

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def assert_param_grads_match(module: torch.nn.Module, flax_grads) -> None:
    """Every torch parameter has a gradient equal to its flax leaf's, and
    no flax leaf is left over."""
    ref = state_dict_from_flax(flax_grads)
    names = {n for n, _ in module.named_parameters()}
    assert names == set(ref)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        # a parameter's gradient sums over all B*S rows, so its rounding
        # follows the largest entries: absolute 1e-4 of max |reference|
        # where that is above 1, else 1e-4 as for the inputs' gradients (a
        # key bias's gradient is zero but for rounding, about 1e-6 under
        # these O(1) cotangents)
        scale = max(1.0, ref[name].abs().max().item())
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("impl, axis, case", [
    # (B, F, N, H, Dh): the step's branches of the packed Pallas backward at
    # a small size (space frame-block, time frame-pair; interpret mode),
    # the same on the XLA path, and odd sizes there.
    ("pallas", "space", (2, 4, 16, 2, 64)),
    ("pallas", "time", (2, 4, 16, 2, 64)),
    ("xla", "space", (2, 4, 16, 2, 64)),
    ("xla", "time", (2, 4, 16, 2, 64)),
    ("xla", "space", (1, 3, 5, 3, 8)),
    ("xla", "time", (2, 5, 7, 2, 24)),
])
def test_divided_attention_gradient_matches_jax(impl, axis, case):
    b, f, n, h, dh = case
    rs = np.random.RandomState(0)
    qkv = rs.randn(b, 1 + f * n, 3, h, dh).astype(np.float32)
    g = rs.randn(b, 1 + f * n, h, dh).astype(np.float32)
    kw = dict(scale=dh ** -0.5, axis=axis, num_frames=f)

    def jfn(x):
        return jdiv.divided_attention(x, impl=impl, **kw)

    with pltpu.force_tpu_interpret_mode():
        ref_out, vjp = jax.vjp(jfn, jnp.asarray(qkv))
        (ref,) = vjp(jnp.asarray(g))

    leaf = torch.from_numpy(qkv).requires_grad_(True)
    out = divided_attention(leaf, **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **TOL)
    # the plain backward the kernels are held against on the card
    plain = divided_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(g), **kw)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
    parts = sum(divided_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(g), rows=rows, **kw)
        for rows in ("grouped", "cls"))
    np.testing.assert_allclose(parts.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_attend_with_the_same_dropout_mask_matches_jax():
    """Value and gradients under probability dropout, both sides with one
    keep-mask: the port draws it from a seeded generator, the test draws
    the same from a generator of that seed and hands it to JAX through
    `attend`'s own formula, its Bernoulli draw replaced (probs/(1-p) where
    kept)."""
    rs = np.random.RandomState(1)
    q, k, v, g = (rs.randn(2, 3, 7, 16).astype(np.float32) for _ in range(4))
    mask = np.ones((2, 7), np.int32)
    mask[0, 4:] = 0
    p = 0.3
    keep = (torch.rand(2, 3, 7, 7, generator=torch.Generator().manual_seed(5))
            < 1.0 - p).numpy()
    assert 0.5 < keep.mean() < 0.9

    def jfn(q, k, v, keep=keep, p=p):
        logits = jnp.einsum("...qd,...kd->...qk", q * 0.25, k)
        logits = logits + jattn.make_additive_mask(jnp.asarray(mask))
        probs = jax.nn.softmax(logits, axis=-1)
        probs = jnp.where(jnp.asarray(keep), probs / (1.0 - p), 0.0)
        return jnp.einsum("...qk,...kd->...qd", probs, v)

    ref, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    # with every probability kept and p = 0 that formula is the package's
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        np.asarray(jattn.attend(*jargs, scale=0.25,
                                bias=jattn.make_additive_mask(jnp.asarray(mask)))),
        np.asarray(jfn(*jargs, keep=np.ones_like(keep), p=0.0)), **TOL)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = tattn.attend(*leaves, scale=0.25,
                       bias=tattn.make_additive_mask(torch.from_numpy(mask)),
                       prob_dropout=p,
                       generator=torch.Generator().manual_seed(5))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    for leaf, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **TOL)


def test_attend_dropout_draws_from_its_generator():
    """The port's own mask: seeded, kept with probability 1 - p, kept
    probabilities scaled by 1/(1 - p); p = 0 draws nothing."""
    q = torch.zeros(4, 8, 32, 16)  # zero logits: uniform probabilities 1/64
    k = torch.zeros(4, 8, 64, 16)
    v = torch.eye(64).expand(4, 8, 64, 64).contiguous()  # out = the probs
    def run(seed, p=0.1, v=v):
        gen = torch.Generator().manual_seed(seed)
        return tattn.attend(q, k, v, scale=1.0, prob_dropout=p, generator=gen), gen
    a, _ = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a > 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01  # 65,536 draws
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 64 / 0.9))
    # without dropout the fused path runs: v's width is the head dim there
    plain, gen = run(0, p=0.0, v=v[..., :16].contiguous())
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())
    torch.testing.assert_close(plain, torch.full_like(plain, 1 / 64))


def test_layernorm_gradient_matches_jax():
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 9, 32) * 0.5 + 3.0).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(32)).astype(np.float32)
    bias = (0.1 * rs.randn(32)).astype(np.float32)
    g = rs.randn(4, 9, 32).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jln.layernorm(*a, eps=1e-6, impl="xla"),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    got = tln.layernorm(*leaves, eps=1e-6)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    for leaf, r in zip(leaves, ref_grads):
        # the gradient of the scale sums 36 rows of O(1) terms
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=2e-4)


# 4 frames of 4x4 patches (S = 65), width 128, 2 heads of 64; every dropout
# rate 0 so that training mode is deterministic on both sides.
VCFG = VideoEncoderConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                          num_heads=2, num_frames=4)
TCFG = TextEncoderConfig(vocab_size=100, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=256,
                         max_position_embeddings=40, hidden_dropout=0.0,
                         attn_dropout=0.0)
FUS = FusionConfig(num_fuse_block=1, dim_video=128, dim_text=128,
                   hidden_size=128)
B, S, ST = 2, 1 + 4 * 16, 6


def _inputs(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, 128).astype(np.float32)
    text = rs.randn(B, ST, 128).astype(np.float32)
    mask = np.ones((B, ST), np.int32)
    mask[1, 4:] = 0
    return x, text, mask, rs


@pytest.mark.parametrize("fused", [False, True])
def test_space_time_block_gradients_match_jax(fused):
    x, text, mask, rs = _inputs(0)
    g = rs.randn(B, S, 128).astype(np.float32)
    jblock = jvideo.SpaceTimeBlock(VCFG, FUS, fused=fused, attn_impl="xla")
    bias = jmask(jnp.asarray(mask))
    init_args = (jnp.asarray(text), bias) if fused else ()
    params = perturb(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), 4,
                                 *init_args)["params"], seed=1)

    def jfn(params, x, text):
        args = (text, bias) if fused else ()
        return jblock.apply({"params": params}, x, 4, *args,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)})

    ref, vjp = jax.vjp(jfn, params, jnp.asarray(x), jnp.asarray(text))
    ref_p, ref_x, ref_text = vjp(jnp.asarray(g))

    tblock = load_flax(tvideo.SpaceTimeBlock(VCFG, FUS, fused=fused),
                       params).train()
    tx = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(text).requires_grad_(True)
    targs = (tt, tmask(torch.from_numpy(mask))) if fused else ()
    got = tblock(tx, 4, *targs)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_x), **TOL)
    if fused:
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref_text), **TOL)
    assert_param_grads_match(tblock, ref_p)


@pytest.mark.parametrize("fused", [False, True])
def test_text_layer_gradients_match_jax(fused):
    video, text, mask, rs = _inputs(2)
    g = rs.randn(B, ST, 128).astype(np.float32)
    bias = jmask(jnp.asarray(mask))
    jlayer = jtext.TextLayer(TCFG, FUS, fused=fused)
    params = perturb(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(text), bias,
                                 jnp.asarray(video) if fused else None)["params"],
                     seed=3)

    def jfn(params, text, video):
        return jlayer.apply({"params": params}, text, bias,
                            video if fused else None, True, False,
                            rngs={"dropout": jax.random.PRNGKey(1)})

    ref, vjp = jax.vjp(jfn, params, jnp.asarray(text), jnp.asarray(video))
    ref_p, ref_text, ref_video = vjp(jnp.asarray(g))

    tlayer = load_flax(ttext.TextLayer(TCFG, FUS, fused=fused), params).train()
    tt = torch.from_numpy(text).requires_grad_(True)
    tv = torch.from_numpy(video).requires_grad_(True)
    got = tlayer(tt, tmask(torch.from_numpy(mask)), tv if fused else None, True)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref_text), **TOL)
    if fused:
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(ref_video), **TOL)
    assert_param_grads_match(tlayer, ref_p)


def test_video_tower_gradients_match_jax():
    """The whole tower from pixels, its fused block fed text, in training
    mode: CLS feature and the gradient of every parameter."""
    cfg = VideoEncoderConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                             num_heads=2, num_frames=3)
    fus = FusionConfig(num_fuse_block=1, dim_video=64, dim_text=64)
    rs = np.random.RandomState(4)
    video = rs.randn(2, 3, 32, 32, 3).astype(np.float32)
    text = rs.randn(2, 4, 64).astype(np.float32)
    g = rs.randn(2, 64).astype(np.float32)
    jvit = jvideo.SpaceTimeViT(cfg, fus, attn_impl="xla")

    def run(m, v, t, det=True):
        return m.finalize(m.run_blocks(m.embed(v, deterministic=det), 3,
                                       text=t, deterministic=det))

    params = perturb(jvit.init(jax.random.PRNGKey(0), jnp.asarray(video),
                               jnp.asarray(text), method=run)["params"], seed=5)
    ref, vjp = jax.vjp(
        lambda p: jvit.apply({"params": p}, jnp.asarray(video),
                             jnp.asarray(text), False, method=run,
                             rngs={"dropout": jax.random.PRNGKey(1)}), params)
    (ref_p,) = vjp(jnp.asarray(g))
    tvit = load_flax(tvideo.SpaceTimeViT(cfg, fus), params).train()
    got = tvit.finalize(tvit.run_blocks(tvit.embed(torch.from_numpy(video)), 3,
                                        text=torch.from_numpy(text)))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert_param_grads_match(tvit, ref_p)


def test_text_tower_gradients_match_jax():
    ids = np.array([[0, 5, 9, 2, 1, 1], [0, 7, 8, 11, 3, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    rs = np.random.RandomState(6)
    video = rs.randn(2, 5, 128).astype(np.float32)
    g = rs.randn(2, 6, 128).astype(np.float32)
    jenc = jtext.TextEncoder(TCFG, FUS)

    def run(m, i, msk, det=True):
        return m.run_layers(m.embed(i, deterministic=det), jmask(msk),
                            video=jnp.asarray(video), deterministic=det)

    params = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                               jnp.asarray(mask), method=run)["params"], seed=6)
    ref, vjp = jax.vjp(
        lambda p: jenc.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                             False, method=run,
                             rngs={"dropout": jax.random.PRNGKey(1)}), params)
    (ref_p,) = vjp(jnp.asarray(g))
    tenc = load_flax(ttext.TextEncoder(TCFG, FUS), params).train()
    got = tenc.run_layers(tenc.embed(torch.from_numpy(ids).long()),
                          tmask(torch.from_numpy(mask)),
                          video=torch.from_numpy(video))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert_param_grads_match(tenc, ref_p)


def test_dropout_and_droppath_in_training_mode():
    """The port's own masks: off at eval and at rate 0, seeded, unbiased."""
    from egovlpv2_torch.models.dropout import Dropout

    x = torch.ones(64, 50, 20)
    for module in (Dropout(0.25), tvideo.DropPath(0.25)):
        assert module.train()(torch.ones(3, 4)).shape == (3, 4)
        assert torch.equal(module.eval()(x), x)
        module.train()
        module.generator = torch.Generator().manual_seed(0)
        a = module(x)
        module.generator = torch.Generator().manual_seed(0)
        assert torch.equal(module(x), a)
        kept = a != 0
        torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
        if isinstance(module, tvideo.DropPath):  # whole samples go together
            per_sample = kept.reshape(64, -1)
            assert (per_sample.all(1) | ~per_sample.any(1)).all()
            assert 0.5 < per_sample[:, 0].float().mean() < 0.95
        else:
            assert abs(kept.float().mean().item() - 0.75) < 0.01
    for zero in (Dropout(0.0), tvideo.DropPath(0.0)):
        assert zero.train()(x) is x
