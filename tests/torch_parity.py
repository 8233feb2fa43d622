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
