"""Divided space-time video transformer, TimeSformer-B/16 family (port of
`egovlpv2_tpu/models/video.py`).

Semantics, as in the JAX package and the reference
`EgoVLPv2/model/video_transformer.py`:
  * the CLS query attends the whole space-time sequence; patch queries
    attend within their frame (space) or patch column (time), plus the
    CLS key (`ops/divided.py`);
  * time attention runs on norm3(x) and its output feeds the *input* of
    space attention, but the residual stream skips it:
    x_out = x + space(norm1(x + time(norm3(x)))) + mlp(...)
    ('frozen-in-time');
  * fused blocks add a gated i2t cross-attention after the space
    projection: x += alpha_i2t * proj(attend(q(norm(x)), kv(text))).

Tokens are [B, S, D] with S = 1 + F*N, CLS first, frame-major patches.
Dropout and DropPath act in `train()` mode only and are inert at the
default rates (0.0); they draw from the generator `EgoVLPv2.set_generator`
hands them. With `remat` every block is one checkpoint region in `train()`
mode (flax's `nn.remat(SpaceTimeBlock)`): its activations are rebuilt in
the backward, with the dropout masks of the first run.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from egovlpv2_torch.core.config import NORM_STATS, FusionConfig, VideoEncoderConfig
from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.dropout import Dropout, checkpoint_region
from egovlpv2_torch.ops.attention import attend
from egovlpv2_torch.ops.divided import divided_attention
from egovlpv2_torch.ops.layernorm import LayerNorm


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm's DropPath): in training, a whole
    sample's branch is dropped with probability `rate` and the kept ones
    are divided by 1 - rate."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 drop: float = 0.0, dtype=None, device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class DividedAttention(nn.Module):
    """Space or time divided attention with the CLS splice, plus the gated
    i2t cross-attention on fused space blocks."""

    def __init__(self, cfg: VideoEncoderConfig, fusion: FusionConfig,
                 axis: str, fused: bool = False, dtype=None, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.axis = axis
        self.fused = fused
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.qkv = Dense(d, 3 * d, bias=cfg.qkv_bias, **kw)
        self.proj = Dense(d, d, **kw)
        self.drop = Dropout(cfg.drop_rate)
        if fused:
            self.qkv_text_i2t = Dense(fusion.dim_text, 2 * d,
                                      bias=cfg.qkv_bias, **kw)
            self.norm_i2t_i = LayerNorm(d, eps=cfg.ln_eps, **kw)
            self.qkv_i2t = Dense(d, d, bias=cfg.qkv_bias, **kw)
            self.proj_i2t = Dense(d, d, **kw)
            self.alpha_i2t = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor, num_frames: int,
                text: Optional[torch.Tensor] = None,
                text_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, d = x.shape
        h, dh = self.num_heads, self.head_dim
        scale = dh ** -0.5
        qkv = self.qkv(x).view(b, s, 3, h, dh)
        out = divided_attention(qkv, scale=scale, axis=self.axis,
                                num_frames=num_frames).reshape(b, s, d)
        x = self.drop(self.proj(out))
        if self.fused and text is not None:
            st = text.shape[1]
            kv_t = self.qkv_text_i2t(text).view(b, st, 2, h, dh)
            kv_t = kv_t.permute(2, 0, 3, 1, 4)
            k_t, v_t = kv_t[0], kv_t[1]
            q_t = self.qkv_i2t(self.norm_i2t_i(x)).view(b, s, h, dh)
            y = attend(q_t.transpose(1, 2), k_t, v_t, scale=scale,
                       bias=text_bias)
            y = self.drop(self.proj_i2t(y.transpose(1, 2).reshape(b, s, d)))
            x = x + self.alpha_i2t.to(x.dtype) * y
        return x


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VideoEncoderConfig, fusion: FusionConfig,
                 fused: bool, drop_path: float = 0.0, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.embed_dim
        self.drop_path = DropPath(drop_path)
        self.norm3 = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.timeattn = DividedAttention(cfg, fusion, "time", **kw)
        self.norm1 = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.attn = DividedAttention(cfg, fusion, "space", fused=fused, **kw)
        self.norm2 = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), d, drop=cfg.drop_rate, **kw)

    def forward(self, x: torch.Tensor, num_frames: int,
                text: Optional[torch.Tensor] = None,
                text_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        time_out = self.timeattn(self.norm3(x), num_frames)
        space_out = self.attn(self.norm1(x + time_out), num_frames,
                              text=text, text_bias=text_bias)
        # 'frozen-in-time' residual: the persistent stream skips time-attn.
        space_residual = x + self.drop_path(space_out)
        return space_residual + self.drop_path(
            self.mlp(self.norm2(space_residual)))


class PatchEmbed(nn.Module):
    """Patchify as space-to-depth plus one matmul, the reference's stride-p
    Conv2d in another form. `weight` is the flax HWIO kernel
    [p, p, C, D]; patches are flattened in (p, p, C) order to match."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int,
                 dtype=None, device=None):
        super().__init__()
        p = patch_size
        self.patch_size = p
        self.compute_dtype = dtype or torch.float32
        self.weight = nn.Parameter(
            torch.zeros(p, p, in_chans, embed_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[BF, H, W, C] -> [BF, N, D] (row-major patches)."""
        p = self.patch_size
        bf, hh, ww, c = x.shape
        x = x.reshape(bf, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(bf, (hh // p) * (ww // p), p * p * c)
        dt = self.compute_dtype
        kernel = self.weight.to(dt).reshape(p * p * c, -1)
        return torch.matmul(x.to(dt), kernel) + self.bias.to(dt)


class SpaceTimeViT(nn.Module):
    """The video tower, with staged execution for the fused paths."""

    def __init__(self, cfg: VideoEncoderConfig, fusion: FusionConfig,
                 dtype=None, device=None, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.generator: Optional[torch.Generator] = None
        d = cfg.embed_dim
        kw = dict(dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(cfg.in_chans, d, cfg.patch_size, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.patches_per_frame + 1, d, device=device))
        self.temporal_embed = nn.Parameter(
            torch.zeros(1, cfg.num_frames, d, device=device))
        num_unfused = cfg.depth - fusion.num_fuse_block
        dpr = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
               for i in range(cfg.depth)]  # linspace(0, rate, depth)
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, fusion, fused=(i >= num_unfused),
                           drop_path=dpr[i], **kw)
            for i in range(cfg.depth))
        self.norm = LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.pos_drop = Dropout(cfg.drop_rate)

    def patchify(self, video: torch.Tensor) -> torch.Tensor:
        """[B, F, H, W, C] -> [B, F*N, D] (frame-major, row-major patches).

        uint8 input is un-normalised frames: the `cfg.uint8_norm` regime
        is applied here, on the device."""
        if video.dtype == torch.uint8:
            mean, std, scale = NORM_STATS[self.cfg.uint8_norm]
            mean = torch.tensor(mean, dtype=torch.float32, device=video.device)
            std = torch.tensor(std, dtype=torch.float32, device=video.device)
            video = (video.float() * scale - mean) / std
        b, f, hh, ww, c = video.shape
        x = self.patch_embed(video.reshape(b * f, hh, ww, c))
        return x.reshape(b, f * self.cfg.patches_per_frame, self.cfg.embed_dim)

    def total_pos_embed(self, num_frames: int, seq_len: int) -> torch.Tensor:
        """Tiled positional + repeated temporal embedding, CLS first.

        Tiled to `cfg.num_frames` and cut to `seq_len`, as the JAX package
        does (`num_frames` is kept for its signature)."""
        n = self.cfg.patches_per_frame
        cls_embed = self.pos_embed[:, :1]
        tile_pos = self.pos_embed[:, 1:].repeat(1, self.cfg.num_frames, 1)
        tile_temporal = self.temporal_embed.repeat_interleave(n, dim=1)
        total = torch.cat([cls_embed, tile_pos + tile_temporal], dim=1)
        return total[:, :seq_len]

    def embed(self, video: Optional[torch.Tensor],
              cls_token: Optional[torch.Tensor] = None,
              tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Patchify (or reuse `tokens`), prepend CLS, add pos/temporal embeds."""
        if tokens is None:
            tokens = self.patchify(video)
        b = tokens.shape[0]
        f = tokens.shape[1] // self.cfg.patches_per_frame
        cls = self.cls_token if cls_token is None else cls_token
        cls = cls.to(tokens.dtype).expand(b, 1, self.cfg.embed_dim)
        x = torch.cat([cls, tokens], dim=1)
        return self.pos_drop(x + self.total_pos_embed(f, x.shape[1]).to(x.dtype))

    def run_blocks(self, x: torch.Tensor, num_frames: int, start: int = 0,
                   end: Optional[int] = None,
                   text: Optional[torch.Tensor] = None,
                   text_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        end = self.cfg.depth if end is None else end
        for i in range(start, end):
            x = self.run_block(x, i, num_frames, text, text_bias)
        return x

    def run_block(self, x, i, num_frames, text=None, text_bias=None):
        blk = self.blocks[i]
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint_region(
                lambda x, text, text_bias: blk(x, num_frames, text, text_bias),
                self.generator)(x, text, text_bias)
        return blk(x, num_frames, text, text_bias)

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """Final LN -> CLS feature."""
        return self.norm(x)[:, 0]

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """Dual-tower forward: [B, F, H, W, C] -> [B, D] CLS feature."""
        x = self.embed(video)
        x = self.run_blocks(x, video.shape[1])
        return self.finalize(x)
