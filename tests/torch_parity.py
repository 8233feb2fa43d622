"""Shared pieces of the tests that hold egovlpv2_torch against egovlpv2_tpu:
tiny configurations, seeded perturbation of flax parameters, and the move
of those parameters into a torch module."""

import numpy as np
import torch
from flax import traverse_util

from egovlpv2_tpu.core.config import (FusionConfig, ModelConfig,
                                      TextEncoderConfig, VideoEncoderConfig)
from egovlpv2_torch.weights import state_dict_from_flax

# 2 frames of 2x2 patches, 2 video blocks and 2 text layers, the last one
# of each fused; Dh = 32.
TINY = ModelConfig(
    video=VideoEncoderConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                             num_heads=2, num_frames=2),
    text=TextEncoderConfig(vocab_size=120, hidden_size=64, num_layers=2,
                           num_heads=2, intermediate_size=128,
                           max_position_embeddings=40),
    fusion=FusionConfig(num_fuse_block=1, dim_video=64, dim_text=64,
                        hidden_size=64),
    projection_dim=16,
    remat=False,
)

# The same as --set overrides of the CLIs.
TINY_OVERRIDES = [
    "model.video.img_size=32", "model.video.embed_dim=64",
    "model.video.depth=2", "model.video.num_heads=2",
    "model.video.num_frames=2", "model.text.vocab_size=120",
    "model.text.hidden_size=64", "model.text.num_layers=2",
    "model.text.num_heads=2", "model.text.intermediate_size=128",
    "model.text.max_position_embeddings=40", "model.fusion.num_fuse_block=1",
    "model.fusion.dim_video=64", "model.fusion.dim_text=64",
    "model.fusion.hidden_size=64", "model.projection_dim=16",
]


def perturb(params, seed: int, std: float = 0.05):
    """Seeded noise on every parameter, so the zero-initialised gates and
    time-attention qkv carry signal; the gates are lifted to about 0.5."""
    rs = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params)
    out = {}
    for path, value in flat.items():
        arr = np.asarray(value, np.float32)
        arr = arr + std * rs.randn(*arr.shape).astype(np.float32)
        if path[-1] in ("alpha_i2t", "alpha_t2i"):
            arr = arr + 0.5
        out[path] = arr
    return traverse_util.unflatten_dict(out)


def load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax tree into `module` through the weight bridge, strictly."""
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


def assert_close_by_max(got, ref, tol: float = 1e-4, err_msg: str = "",
                        floor: float = 0.0):
    """`got` (a tensor, None for a gradient never written, or an array)
    within tol of the largest |ref| of `ref` (an array), or of `floor`
    where that is larger, element by element, and of its shape."""
    ref = np.asarray(ref)
    if got is None:
        got = np.zeros_like(ref)
    elif isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, floor)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=err_msg)


def assert_steps_match(model: torch.nn.Module, ref_params, step_grads: list,
                       lr_sum: float, tol: float = 2e-4,
                       noise_rel: float = 1e-5):
    """The parameters of `model` after a few Adam or AdamW steps against the
    flax tree `ref_params` of the same steps in optax: within `tol` (times
    |param| where that is above 1).

    Adam divides each element's step by its own input's magnitude, so at a
    step where an element's input (the gradient, plus an L2 term where
    there is one) is within f32 noise of zero and its gradient is not
    exactly 0 (which both packages take alike), the element steps by about
    the rate in a direction set by that noise, in each package its own.
    Noise here: an input below `noise_rel` of its tensor's largest
    gradient, or any element of a tensor whose largest gradient is below
    `noise_rel` of the largest of all (an attention's key bias: a softmax
    over keys does not see a shift common to all of them). `step_grads`
    holds the port's (gradient, Adam's input) of each step by name;
    elements noisy at some step are held to 2 `lr_sum` (the steps' rates
    added) and must be under 1% of all."""
    from egovlpv2_torch.weights import state_dict_from_flax

    ref = state_dict_from_flax(ref_params)
    tops = [max(g.abs().max().item() for g, _ in grads.values())
            for grads in step_grads]
    noisy = total = 0
    for name, p in model.named_parameters():
        rounding = torch.zeros(p.shape, dtype=torch.bool)
        for grads, top in zip(step_grads, tops):
            g, adam_in = grads[name]
            most = g.abs().max()
            rounding |= (g != 0) & ((adam_in.abs() < noise_rel * most)
                                    | (most < noise_rel * top))
        scale = max(1.0, ref[name].abs().max().item())
        atol = torch.where(rounding, torch.tensor(2 * lr_sum),
                           torch.tensor(tol * scale))
        err = (p.detach().cpu() - ref[name]).abs()
        assert (err <= atol + tol * ref[name].abs()).all(), \
            (name, err.max().item())
        noisy += int(rounding.sum())
        total += p.numel()
    assert noisy < 0.01 * total, (noisy, total)


def assert_grads_match(model: torch.nn.Module, ref_grads, tol: float = 1e-4):
    """Every parameter's gradient in `model` against the flax tree of
    reference gradients, name for name: within tol of the largest |ref| of
    its tensor. A tensor whose largest gradient is under 1e-2 of the
    largest of all (an attention's key bias, zero but for rounding: a
    softmax over keys does not see a shift common to all of them) is held
    to tol of 1e-2 of that largest."""
    from egovlpv2_torch.weights import state_dict_from_flax

    ref = state_dict_from_flax(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    top = max(r.abs().max().item() for r in ref.values())
    for name, p in named.items():
        assert_close_by_max(p.grad, ref[name], tol, err_msg=name,
                            floor=1e-2 * top)


def assert_init_like_flax(model: torch.nn.Module, flax_params,
                          rel: float = 0.15):
    """`model`'s parameters as drawn by the port (`weights.flax_init_`)
    against a flax init of the same model, name for name: the same shapes;
    zeros and ones where flax's are; elsewhere a mean near 0 and a standard
    deviation within `rel` of flax's (tensors of 256 elements or more)."""
    from egovlpv2_torch.weights import state_dict_from_flax

    ref = state_dict_from_flax(flax_params)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        got, want = p.detach().cpu(), ref[name]
        assert got.shape == want.shape, name
        if (want == 0).all() or (want == 1).all():
            assert torch.equal(got, want), name
        elif want.numel() >= 256:
            std = want.std().item()
            assert abs(got.std().item() - std) <= rel * std, name
            assert abs(got.mean().item()) <= 4 * std / want.numel() ** 0.5, name
