"""The production geometry of EgoVLPv2 against the JAX package on the CPU,
f32, at a narrow width: 12 video blocks and 12 text layers, the last 6 of
each fused (TimeSformer-B/16 + RoBERTa-base's depth), embed 64, 2 heads,
2 frames of 2x2 patches. `itm_forward` and `mlm_forward` logits, and the
gradient of sum(logits * cotangent) for every parameter; then the EgoTaskQA
model's logits and gradients through `fused_encode` at that depth. Dropout
0. Logits within 1e-4 of max(1, max |reference|); a gradient within 1e-3
of max(1, max |reference|) of its tensor: f32 GEMMs in another order
through 24 blocks, and a fused gate's gradient is one scalar summed over
every token of its layer (against a float64 run of the port, the port in
f32 was 7.9e-4 off on the worst gate, alpha_t2i of the first fused text
layer under `mlm_forward`, and the JAX package 3.8e-5). A parameter the
method does not reach has a zero gradient in JAX and none in PyTorch."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.downstream import taskqa as jqa
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.downstream import taskqa as tqa
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.weights import state_dict_from_flax
from torch_parity import perturb

torch.set_num_threads(2)
BATCH, TEXT_LEN, ANSWERS = 2, 8, 3


def _configs():
    out = []
    for mod in (jconfig, tconfig):
        out.append(mod.ModelConfig(
            video=mod.VideoEncoderConfig(img_size=32, patch_size=16,
                                         embed_dim=64, depth=12, num_heads=2,
                                         num_frames=2),
            text=mod.TextEncoderConfig(vocab_size=120, hidden_size=64,
                                       num_layers=12, num_heads=2,
                                       intermediate_size=128,
                                       max_position_embeddings=40,
                                       hidden_dropout=0.0, attn_dropout=0.0),
            fusion=mod.FusionConfig(num_fuse_block=6, dim_video=64,
                                    dim_text=64, hidden_size=64),
            projection_dim=16, remat=False, attn_impl="xla"))
    return out


def _inputs():
    rs = np.random.RandomState(11)
    video = rs.randn(BATCH, 2, 32, 32, 3).astype(np.float32)
    ids = rs.randint(4, 118, (BATCH, TEXT_LEN)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((BATCH, TEXT_LEN), np.int32)
    ids[1, 5], ids[1, 6:], mask[1, 6:] = 2, 1, 0
    return video, ids, mask, rs


@pytest.mark.parametrize("method", ["itm_forward", "mlm_forward", "qa"])
def test_twelve_blocks_six_fused_match_jax(method):
    jcfg, tcfg = _configs()
    video, ids, mask, rs = _inputs()
    args = (jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask))
    if method == "qa":
        jmodel = jqa.make_qa_model(jcfg, ANSWERS)
        params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]
        model = tqa.make_qa_model(tcfg, ANSWERS)
        width = ANSWERS
    else:
        jmodel = JaxEgoVLPv2(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0), *args,
                             method=jmodel.init_all)["params"]
        model = EgoVLPv2(tcfg)
        width = 2 if method == "itm_forward" else tcfg.text.vocab_size
    params = perturb(params, seed=12)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()
    shape = (BATCH, width) if method != "mlm_forward" else (BATCH, TEXT_LEN, width)
    cot = rs.randn(*shape).astype(np.float32)

    def jfn(p):
        if method == "qa":
            return jmodel.apply({"params": p}, *args)
        return jmodel.apply({"params": p}, *args, method=getattr(jmodel, method))

    ref, vjp = jax.vjp(jfn, params)
    (ref_grads,) = vjp(jnp.asarray(cot))
    t = [torch.from_numpy(a) for a in (video, ids, mask)]
    t[1] = t[1].long()
    got = model(*t) if method == "qa" else getattr(model, method)(*t)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    (got * torch.from_numpy(cot)).sum().backward()
    ref_grads = state_dict_from_flax(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    assert sum(n.startswith(("video_model.blocks.11", "backbone.video_model.blocks.11"))
               for n in named) > 0
    reached = 0
    for name, p in named.items():
        r = ref_grads[name]
        if p.grad is None:
            assert not r.any(), name
            continue
        reached += 1
        np.testing.assert_allclose(
            p.grad.numpy(), r.numpy(), rtol=1e-3, err_msg=name,
            atol=1e-3 * max(1.0, r.abs().max().item()))
    assert reached > len(named) // 2
