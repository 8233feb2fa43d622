"""The weight bridge between the flax tree of egovlpv2_tpu and the
state_dict of egovlpv2_torch (parameters, and trees shaped like them:
gradients), and the port's seeded random fill."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.ops.layernorm import LayerNorm
from egovlpv2_torch.weights import (flax_from_state_dict, flax_path,
                                    random_init_, state_dict_from_flax)
from torch_parity import TINY, perturb

torch.set_num_threads(2)


def _flax_params():
    m = JaxEgoVLPv2(TINY)
    v = TINY.video
    params = m.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, v.num_frames, v.img_size, v.img_size, 3)),
                    jnp.zeros((1, 5), jnp.int32), jnp.ones((1, 5), jnp.int32),
                    method=m.init_all)["params"]
    return perturb(params, seed=0)


def test_bridge_loads_strictly_and_round_trips_exactly():
    params = _flax_params()
    sd = state_dict_from_flax(params)
    model = EgoVLPv2(TINY)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(model.state_dict())

    # flax -> torch -> flax is the identity, leaf for leaf
    back = traverse_util.flatten_dict(flax_from_state_dict(model.state_dict()))
    flat = traverse_util.flatten_dict(params)
    assert set(back) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(value), err_msg=str(path))

    # torch -> flax -> torch is the identity too
    again = state_dict_from_flax(flax_from_state_dict(model.state_dict()))
    for name, tensor in model.state_dict().items():
        assert torch.equal(again[name], tensor), name


def test_no_leaf_and_no_parameter_is_left_unmapped():
    """init_all's tree (dual towers, fused stack, ITM and MLM heads) and
    the port's parameters map one to one, by name and by shape; a tree of
    gradients takes the same way."""
    params = _flax_params()
    flat = traverse_util.flatten_dict(params)
    model = EgoVLPv2(TINY)
    named = dict(model.named_parameters())
    assert not list(model.named_buffers())
    paths = {flax_path(name, p.dim()): name for name, p in named.items()}
    assert len(paths) == len(named) and set(paths) == set(flat)
    assert any(p[0] == "mlm_score" for p in paths)
    grads = traverse_util.unflatten_dict(
        {path: np.full(np.shape(v), i, np.float32)
         for i, (path, v) in enumerate(sorted(flat.items()))})
    bridged = state_dict_from_flax(grads)
    assert set(bridged) == set(named)
    for i, (path, _) in enumerate(sorted(flat.items())):
        name = paths[path]
        assert bridged[name].shape == named[name].shape, name
        assert (bridged[name] == i).all(), name


def test_bridge_layouts():
    params = _flax_params()
    sd = state_dict_from_flax(params)
    qkv = params["video_model"]["blocks_1"]["attn"]["qkv"]["kernel"]
    assert torch.equal(sd["video_model.blocks.1.attn.qkv.weight"],
                       torch.from_numpy(np.asarray(qkv).T))
    patch = params["video_model"]["patch_embed"]["kernel"]
    assert tuple(sd["video_model.patch_embed.weight"].shape) == patch.shape
    emb = params["text_model"]["embeddings"]["word_embeddings"]["embedding"]
    assert torch.equal(sd["text_model.embeddings.word_embeddings.weight"],
                       torch.from_numpy(np.asarray(emb)))
    ln = params["text_model"]["layer_0"]["attention_LayerNorm"]["scale"]
    assert torch.equal(sd["text_model.layer.0.attention_LayerNorm.weight"],
                       torch.from_numpy(np.asarray(ln)))
    assert "text_model.layer.1.alpha_t2i" in sd and "cls_token" in sd


def test_random_init_is_seeded_and_fills_every_parameter():
    a = random_init_(EgoVLPv2(TINY), torch.Generator().manual_seed(7))
    b = random_init_(EgoVLPv2(TINY), torch.Generator().manual_seed(7))
    c = random_init_(EgoVLPv2(TINY), torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    assert not torch.equal(sa["video_model.pos_embed"], sc["video_model.pos_embed"])
    assert torch.equal(sa["video_model.blocks.1.attn.alpha_i2t"],
                       torch.full((1,), 0.5))
    assert sa["video_model.blocks.0.timeattn.qkv.weight"].abs().sum() > 0
    for m in a.modules():
        if isinstance(m, LayerNorm):
            assert (m.weight - 1).abs().max() < 0.2
