"""egovlpv2_torch.train.optimizer against egovlpv2_tpu.train.optimizer: the
group of every parameter of the full-width model, the schedules, and AdamW
updates on a toy tree."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from egovlpv2_tpu.core.config import ModelConfig as JModelConfig
from egovlpv2_tpu.core.config import OptimConfig as JOptimConfig
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.train import optimizer as jopt
from egovlpv2_torch.core.config import ModelConfig, OptimConfig
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.train import optimizer as topt
from egovlpv2_torch.weights import flax_path

torch.set_num_threads(2)


def test_every_full_width_parameter_gets_the_jax_label():
    """TimeSformer-B/16 + RoBERTa-base, 6 fused, both heads: shapes only
    (jax.eval_shape, torch's meta device), so no memory is taken."""
    jmodel = JaxEgoVLPv2(JModelConfig(attn_impl="xla", remat=False))
    v = jmodel.cfg.video
    shapes = jax.eval_shape(
        lambda: jmodel.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, v.num_frames, v.img_size, v.img_size, 3)),
            jnp.zeros((1, 15), jnp.int32), jnp.ones((1, 15), jnp.int32),
            method=jmodel.init_all))["params"]
    ref = {path: jopt.param_label(path)
           for path in traverse_util.flatten_dict(shapes)}
    model = EgoVLPv2(ModelConfig(), device="meta")
    got = topt.label_parameters(model)
    by_path = {flax_path(name, p.dim()): got[name]
               for name, p in model.named_parameters()}
    assert len(by_path) == len(got) == len(ref) > 500
    assert by_path == ref
    assert set(ref.values()) == set(topt.GROUPS)
    # the two quirks of the reference
    assert got["video_model.blocks.3.norm3.weight"] == "backbone_wd"
    assert got["video_model.blocks.3.norm1.weight"] == "backbone_nd"
    assert got["video_model.blocks.9.attn.alpha_i2t"] == "cross_wd"
    assert got["text_model.layer.9.alpha_t2i"] == "cross_wd"
    groups = topt.param_groups(OptimConfig(), model)
    assert [g["name"] for g in groups] == list(topt.GROUPS)
    assert sum(len(g["params"]) for g in groups) == len(got)
    for g in groups:
        kind, decay = g["name"].split("_")
        assert g["lr"] == pytest.approx(3e-5 * (1.0 if kind == "backbone" else 4.0))
        assert g["weight_decay"] == (0.01 if decay == "wd" else 0.0)


@pytest.mark.parametrize("kw", [
    dict(decay_power="cosine", max_steps=1000, warmup_frac=0.1),
    dict(decay_power="poly1", max_steps=500, warmup_frac=0.05, end_lr=1e-7),
    dict(decay_power="2.0", max_steps=300, warmup_frac=0.1, end_lr=3e-6),
    dict(decay_power="cosine", max_steps=10, warmup_frac=0.1),
    dict(decay_power="cosine", max_steps=400, warmup_frac=25),
], ids=["cosine", "poly1", "poly2", "ten_steps", "warmup_in_steps"])
def test_schedule_matches_optax(kw):
    """At steps 0, 1, the warmup's end and its neighbours, the middle, the
    end and beyond, for the backbone's and a multiplied group's peak."""
    for scale in (1.0, 4.0):
        ref = jopt.make_schedule(JOptimConfig(**kw), lr_scale=scale)
        factor = topt.make_schedule(OptimConfig(**kw))
        warm = max(int(kw["warmup_frac"] * kw["max_steps"]), 1) \
            if kw["warmup_frac"] < 1 else int(kw["warmup_frac"])
        n = kw["max_steps"]
        for count in sorted({0, 1, warm - 1, warm, warm + 1, n // 2, n - 1, n,
                             n + 7} - {-1}):
            want = float(ref(count))
            got = 3e-5 * scale * factor(count)
            assert got == pytest.approx(want, rel=1e-5, abs=1e-12), count
    assert factor(0) == 0.0


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adamw_groups_update_like_optax(grad_clip):
    """Five updates of a toy tree whose leaves fall in all six groups, from
    the same gradients: the parameters stay within 1e-6 (f32 rounding of
    the moments)."""
    kw = dict(lr=1e-2, max_steps=10, warmup_frac=0.2, weight_decay=0.1,
              grad_clip=grad_clip)
    rs = np.random.RandomState(0)
    paths = [("video_model", "blocks_0", "attn", "qkv", "kernel"),
             ("video_model", "blocks_0", "attn", "qkv", "bias"),
             ("txt_proj", "fc1", "kernel"), ("txt_proj", "fc1", "bias"),
             ("text_model", "layer_1", "alpha_t2i"),
             ("cross_modal_text_transform", "bias")]
    params = {p: rs.randn(4, 3).astype(np.float32) if p[-1] == "kernel"
              else rs.randn(3).astype(np.float32) for p in paths}
    assert {jopt.param_label(p) for p in paths} == set(topt.GROUPS)
    jparams = traverse_util.unflatten_dict({p: jnp.asarray(a) for p, a in params.items()})
    tx = jopt.make_optimizer(JOptimConfig(**kw), jparams)
    state = tx.init(jparams)

    def build(tree):
        """A bare module tree with the flax tree's names (a name such as
        `blocks_0` stays as it is: `flax_path` rewrites only numeric list
        entries, so both packages label the same path)."""
        module = torch.nn.Module()
        for key, value in tree.items():
            if isinstance(value, dict):
                module.add_module(key, build(value))
            elif key == "kernel":
                module.register_parameter("weight", torch.nn.Parameter(
                    torch.from_numpy(value.T.copy())))
            else:
                module.register_parameter(key, torch.nn.Parameter(
                    torch.from_numpy(value.copy())))
        return module

    toy = build(traverse_util.unflatten_dict(params))
    optimizer, scheduler = topt.make_optimizer(OptimConfig(**kw), toy)
    named = dict(toy.named_parameters())
    for step in range(5):
        grads = {p: (rs.randn(*a.shape) * 3).astype(np.float32) for p, a in params.items()}
        jgrads = traverse_util.unflatten_dict({p: jnp.asarray(g) for p, g in grads.items()})
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in grads.items():
            name = ".".join(p[:-1] + ("weight" if p[-1] == "kernel" else p[-1],))
            named[name].grad = torch.from_numpy(g.T.copy() if p[-1] == "kernel" else g.copy())
        if grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(list(named.values()), grad_clip)
        optimizer.step()
        scheduler.step()
        flat = traverse_util.flatten_dict(jparams)
        for p in paths:
            name = ".".join(p[:-1] + ("weight" if p[-1] == "kernel" else p[-1],))
            got = named[name].detach().numpy()
            want = np.asarray(flat[p]).T if p[-1] == "kernel" else np.asarray(flat[p])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{p} after step {step}")
        if step == 0:  # lr 0 at count 0: nothing moved
            for p in paths:
                np.testing.assert_array_equal(np.asarray(flat[p]), params[p])
