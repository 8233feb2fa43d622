"""egovlpv2_torch.models against egovlpv2_tpu.models on the CPU, on flax
parameters (seeded and perturbed so the gates and the time-attention qkv
are non-zero) bridged by egovlpv2_torch.weights."""

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
from egovlpv2_tpu.ops.attention import make_additive_mask as jmask
from egovlpv2_torch.models import text as ttext
from egovlpv2_torch.models import video as tvideo
from egovlpv2_torch.ops.attention import make_additive_mask as tmask
from torch_parity import load_flax, perturb

torch.set_num_threads(2)

# 4 frames of 4x4 patches (S = 65), width 128, 2 heads of 64.
VCFG = VideoEncoderConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                          num_heads=2, num_frames=4)
TCFG = TextEncoderConfig(vocab_size=100, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=256,
                         max_position_embeddings=40)
FUS = FusionConfig(num_fuse_block=1, dim_video=128, dim_text=128,
                   hidden_size=128)
B, S, ST = 2, 1 + 4 * 16, 6


def _inputs(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, 128).astype(np.float32)
    text = rs.randn(B, ST, 128).astype(np.float32)
    mask = np.ones((B, ST), np.int32)
    mask[1, 4:] = 0
    return x, text, mask


@pytest.mark.parametrize("fused", [False, True])
def test_space_time_block_matches_jax(fused):
    x, text, mask = _inputs(0)
    args = (jnp.asarray(text), jmask(jnp.asarray(mask))) if fused else ()
    jblock = jvideo.SpaceTimeBlock(VCFG, FUS, fused=fused, attn_impl="pallas")
    init_block = jvideo.SpaceTimeBlock(VCFG, FUS, fused=fused, attn_impl="xla")
    params = perturb(init_block.init(jax.random.PRNGKey(0), jnp.asarray(x), 4,
                                     *args)["params"], seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = jblock.apply({"params": params}, jnp.asarray(x), 4, *args)

    tblock = load_flax(tvideo.SpaceTimeBlock(VCFG, FUS, fused=fused), params)
    targs = ((torch.from_numpy(text), tmask(torch.from_numpy(mask)))
             if fused else ())
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x), 4, *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fused, last_norm", [(False, True), (True, True),
                                              (True, False)])
def test_text_layer_matches_jax(fused, last_norm):
    video, text, mask = _inputs(2)
    bias = jmask(jnp.asarray(mask))
    vid = jnp.asarray(video) if fused else None
    jlayer = jtext.TextLayer(TCFG, FUS, fused=fused)
    params = perturb(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(text),
                                 bias, vid)["params"], seed=3)
    ref = jlayer.apply({"params": params}, jnp.asarray(text), bias, vid,
                       last_norm)

    tlayer = load_flax(ttext.TextLayer(TCFG, FUS, fused=fused), params)
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(text), tmask(torch.from_numpy(mask)),
                     torch.from_numpy(video) if fused else None, last_norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_video_tower_embed_and_uint8_patchify_match_jax():
    """patchify of uint8 frames (on-device normalisation), the tiled
    positional + temporal embedding and the full dual-tower forward."""
    cfg = VideoEncoderConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                             num_heads=2, num_frames=3)
    fus = FusionConfig(num_fuse_block=1, dim_video=64, dim_text=64)
    video = np.random.RandomState(4).randint(0, 256, (2, 3, 32, 32, 3)).astype(
        np.uint8)
    jvit = jvideo.SpaceTimeViT(cfg, fus)
    text = jnp.ones((2, 4, 64), jnp.float32)

    def touch_all(m, v):  # the fused block's i2t parameters too
        return m.finalize(m.run_blocks(m.embed(v), 3, text=text))

    params = perturb(jvit.init(jax.random.PRNGKey(0), jnp.asarray(video),
                               method=touch_all)["params"], seed=5)
    ref = jvit.apply({"params": params}, jnp.asarray(video))
    ref_pos = jvit.apply({"params": params}, 2, 7,
                         method=jvit.total_pos_embed)

    tvit = load_flax(tvideo.SpaceTimeViT(cfg, fus), params)
    with torch.inference_mode():
        got = tvit(torch.from_numpy(video))
        got_pos = tvit.total_pos_embed(2, 7)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(ref_pos), rtol=0,
                               atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_text_encoder_and_position_ids_match_jax():
    ids = np.array([[0, 5, 9, 2, 1, 1], [0, 7, 8, 11, 3, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    np.testing.assert_array_equal(
        ttext.create_position_ids(torch.from_numpy(ids), 1).numpy(),
        np.asarray(jtext.create_position_ids(jnp.asarray(ids), 1)))
    jenc = jtext.TextEncoder(TCFG, FUS)
    video = jnp.ones((2, 5, 128), jnp.float32)

    def touch_all(m, i, msk):  # the fused layer's t2i parameters too
        return m.run_layers(m.embed(i), jmask(msk), video=video)

    params = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                               jnp.asarray(mask), method=touch_all)["params"],
                     seed=6)
    ref = jenc.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    tenc = load_flax(ttext.TextEncoder(TCFG, FUS), params)
    with torch.inference_mode():
        got = tenc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
