"""Configuration tree of the port: the port's own copy of
`egovlpv2_tpu/core/config.py`, field for field, so that every
`configs/*.json` loads into both packages alike (a test holds the two
`load_train_config`s against each other on each file).

One frozen dataclass tree, hashable and serializable. Two fields name
machinery of the JAX package and are kept so those files still load:
  * `model.attn_impl` is ignored: the port picks by device (a CUDA tensor
    takes the hand-written kernels, a CPU tensor the plain version);
  * `model.remat` makes every video block and text layer one
    `torch.utils.checkpoint` region in training and is ignored at
    evaluation; `path_remat` (one region per objective path) is honoured
    where `model.remat` is off.
`load_train_config` and `apply_overrides` are the JSON loader and the
`--set dotted.key=value` overrides of the command line.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Canonical normalization regimes (on-device uint8 normalization in
# models/video.py patchify):
# (mean, std, input_scale) — x.astype(f32) * scale, then (x - mean) / std.
# "imagenet": 0-1 floats (reference transforms.py:42-70); "epic": 0-255
# units (EpicKitchens_MIR_dataset.py:147-159).
NORM_STATS = {
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 1.0 / 255.0),
    "epic": ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375), 1.0),
}


@dataclass(frozen=True)
class VideoEncoderConfig:
    """TimeSformer-B/16 style divided space-time ViT.

    Mirrors reference `EgoVLPv2/model/video_transformer.py:231`
    (SpaceTimeTransformer defaults).
    """

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    num_frames: int = 4
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # LayerNorm eps inside blocks & final norm; reference uses torch default
    # 1e-5 (nn.LayerNorm passed as the default `norm_layer`).
    ln_eps: float = 1e-5
    # normalization regime applied ON DEVICE when the video input arrives
    # as uint8 (un-normalized frames, 4x fewer host->device bytes):
    # "imagenet" ((x/255 - mean)/std) or "epic" (0-255 mean/std). f32
    # inputs are assumed host-normalized.
    uint8_norm: str = "imagenet"

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return 1 + self.num_frames * self.patches_per_frame

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class TextEncoderConfig:
    """RoBERTa-base equivalent (reference vendored copy `model/roberta.py:712`)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class FusionConfig:
    """FIBER-style gated cross-attention fusion in the last N blocks.

    `num_fuse_block` mirrors `EgoNCE_MLM_ITM_Config.yml:16`; gates start at 0
    so the fused model boots as two independent dual encoders
    (`video_transformer.py:114`, `roberta.py:440`).
    """

    num_fuse_block: int = 6
    dim_video: int = 768  # "input_image_embed_size"
    dim_text: int = 768  # "input_text_embed_size"
    hidden_size: int = 768  # cross-modal transform width
    # model-level fused-path final LN eps (reference: partial(LayerNorm, 1e-6)
    # at model/model.py:154)
    ln_eps: float = 1e-6


@dataclass(frozen=True)
class ModelConfig:
    video: VideoEncoderConfig = field(default_factory=VideoEncoderConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    # 'minimal' -> 3-layer MLP projections to projection_dim
    # (model/model.py:103-115); 'small' -> the fine-tune variant
    # (model_epic_charades.py:118-119); '' -> identity.
    projection: str = "minimal"
    projection_dim: int = 4096
    # which task heads to build
    with_itm_head: bool = True
    with_mlm_head: bool = True
    # the JAX package's attention implementation switch; ignored by the port
    # (see the module docstring)
    attn_impl: str = "auto"
    # remat (gradient checkpointing) on every block, like
    # `use_checkpoint: True` in the reference YAML; see the module docstring
    remat: bool = True
    # activation dtype (the reference uses fp16 AMP + GradScaler; bf16
    # needs no scaler).
    compute_dtype: str = "float32"

    @property
    def num_unfused(self) -> int:
        return self.text.num_layers - self.fusion.num_fuse_block


@dataclass(frozen=True)
class OptimConfig:
    """AdamW with the reference's 6 param groups (set_optim_schedule.py:16-108)."""

    lr: float = 3e-5
    lr_mult_head: float = 4.0
    lr_mult_cross_modal: float = 4.0
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    decay_power: str = "cosine"  # or "poly1"
    warmup_frac: float = 0.1
    end_lr: float = 1e-7
    max_steps: int = 100_000
    grad_clip: Optional[float] = None


@dataclass(frozen=True)
class LossConfig:
    type: str = "EgoNCE"  # EgoNCE | NormSoftmax | AdaptiveMaxMargin | MaxMargin
    temperature: float = 0.05
    noun: bool = True
    verb: bool = True
    margin: float = 0.2
    itm_weight: float = 2.0
    mlm_weight: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    tasks: str = "EgoNCE_ITM_MLM"
    # one checkpoint region per objective path (peak memory = max over
    # paths). Turn off when activations fit: backward then reuses the stored
    # forward instead of recomputing each tower.
    path_remat: bool = True
    # per-step grad-norm metric: a full-gradient reduction sweep; opt in
    # when diagnosing.
    log_grad_norm: bool = False
    global_batch_size: int = 256
    # cap an epoch at this many (global) loader samples; 0 = full dataset.
    # The reference trains "20 epochs x 500k clips" of the 3.8M-clip EgoClip
    # table (trainer_egoclip.py:108, configs/pt/egoclip.json:70).
    max_samples_per_epoch: int = 0
    max_text_len: int = 15  # tokenizer max_length at pretrain (trainer_egoclip.py:120)
    mlm_prob: float = 0.15
    seed: int = 0
    # mesh axes of the JAX package (kept so its config files load).
    mesh_shape: Tuple[int, ...] = (-1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def apply_overrides(cfg, overrides):
    """Apply `dotted.key=value` strings (values parsed as JSON, else kept
    as text) to a frozen dataclass tree; returns the new tree."""
    for item in overrides or []:
        key, _, raw = item.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw

        def rec(node, parts):
            if len(parts) == 1:
                return dataclasses.replace(node, **{parts[0]: value})
            child = getattr(node, parts[0])
            return dataclasses.replace(node, **{parts[0]: rec(child, parts[1:])})

        cfg = rec(cfg, key.split("."))
    return cfg


def load_train_config(path=None, overrides=None) -> TrainConfig:
    """TrainConfig from a JSON file (or the defaults), then the overrides.
    Keys starting with '_' are comments; an unknown key raises."""
    cfg = TrainConfig()
    if path:
        with open(path) as f:
            raw = json.load(f)

        def build(cls, data):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in data.items():
                if k.startswith("_"):
                    continue
                if k not in fields:
                    raise KeyError(f"unknown config key {k} for {cls.__name__}")
                if isinstance(v, dict):
                    # nested dataclass types resolved from this level's default
                    kwargs[k] = build(type(getattr(cls(), k)), v)
                else:
                    kwargs[k] = tuple(v) if isinstance(v, list) else v
            return cls(**kwargs)

        cfg = build(TrainConfig, raw)
    return apply_overrides(cfg, overrides)
