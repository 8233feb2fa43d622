"""EgoVLPv2: dual encoders plus the fusion-in-the-backbone stack (port of
`egovlpv2_tpu/models/egovlp.py`).

The fused path has its own CLS token and final LayerNorm (eps
`fusion.ln_eps`), distinct from the dual video tower's. At each fused
depth, text attends the video tokens from *before* that depth's update.
Where the JAX methods take `deterministic`, the module's `train()` /
`eval()` mode decides; `set_generator` hands every dropout of the model
the generator its masks are drawn from.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from egovlpv2_torch.core.config import ModelConfig
from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.heads import ITMHead, MLMHead, Pooler
from egovlpv2_torch.models.text import TextEncoder
from egovlpv2_torch.models.video import SpaceTimeViT
from egovlpv2_torch.ops.attention import make_additive_mask
from egovlpv2_torch.ops.layernorm import LayerNorm


class _ProjMLP(nn.Module):
    """`_proj_mlp`, the 'minimal' projection:
    Linear(no bias) -> ReLU -> Linear -> ReLU -> Linear."""

    def __init__(self, in_dim: int, dim: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc0 = Dense(in_dim, dim, bias=False, **kw)
        self.fc1 = Dense(dim, dim, **kw)
        self.fc2 = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(torch.relu(self.fc0(x)))))


class _ProjSmall(nn.Module):
    """`_proj_small`, the fine-tune projection: [ReLU ->] Linear."""

    def __init__(self, in_dim: int, dim: int, relu_first: bool, dtype=None,
                 device=None):
        super().__init__()
        self.relu_first = relu_first
        self.fc0 = Dense(in_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc0(torch.relu(x) if self.relu_first else x)


class EgoVLPv2(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        kw = dict(dtype=dtype, device=device)
        dv, dt = cfg.video.embed_dim, cfg.text.hidden_size
        self.video_model = SpaceTimeViT(cfg.video, cfg.fusion,
                                        remat=cfg.remat, **kw)
        self.text_model = TextEncoder(cfg.text, cfg.fusion, remat=cfg.remat,
                                      **kw)
        if cfg.projection == "minimal":
            self.txt_proj = _ProjMLP(dt, cfg.projection_dim, **kw)
            self.vid_proj = _ProjMLP(dv, cfg.projection_dim, **kw)
        elif cfg.projection == "small":
            self.txt_proj = _ProjSmall(dt, cfg.projection_dim, True, **kw)
            self.vid_proj = _ProjSmall(dv, cfg.projection_dim, False, **kw)
        else:
            self.txt_proj = self.vid_proj = None
        if cfg.with_itm_head or cfg.with_mlm_head:
            hs = cfg.fusion.hidden_size
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dv, device=device))
            self.norm = LayerNorm(dv, eps=cfg.fusion.ln_eps, **kw)
            self.cross_modal_text_transform = Dense(dt, hs, **kw)
            self.cross_modal_video_transform = Dense(dv, hs, **kw)
            self.cross_modal_text_pooler = Pooler(hs, **kw)
            self.cross_modal_video_pooler = Pooler(hs, **kw)
        if cfg.with_itm_head:
            self.itm_score = ITMHead(2 * cfg.fusion.hidden_size, **kw)
        if cfg.with_mlm_head:
            self.mlm_score = MLMHead(cfg.fusion.hidden_size,
                                     cfg.text.vocab_size, **kw)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every random draw of the model in training mode (dropout masks,
        DropPath, attention-probability dropout) comes from `generator`,
        which must live on the model's device; None gives them back to
        PyTorch's global generator."""
        for module in self.modules():
            if hasattr(module, "generator"):
                module.generator = generator

    # ---------------- dual towers ----------------

    def patchify(self, video: torch.Tensor) -> torch.Tensor:
        """Patch-embed once for reuse across the EgoNCE/ITM/MLM passes."""
        return self.video_model.patchify(video)

    def _num_frames(self, video, video_tokens, num_frames) -> int:
        if video is not None:
            return video.shape[1]
        if num_frames is not None:
            return num_frames
        return video_tokens.shape[1] // self.cfg.video.patches_per_frame

    def compute_video(self, video: Optional[torch.Tensor],
                      video_tokens: Optional[torch.Tensor] = None,
                      num_frames: Optional[int] = None,
                      project: bool = True) -> torch.Tensor:
        f = self._num_frames(video, video_tokens, num_frames)
        x = self.video_model.embed(video, tokens=video_tokens)
        x = self.video_model.finalize(self.video_model.run_blocks(x, f))
        if project and self.vid_proj is not None:
            x = self.vid_proj(x)
        return x

    def compute_text(self, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor,
                     project: bool = True) -> torch.Tensor:
        x = self.text_model(input_ids, attention_mask)[:, 0]
        if project and self.txt_proj is not None:
            x = self.txt_proj(x)
        return x

    def compute_text_tokens(self, input_ids: torch.Tensor,
                            attention_mask: torch.Tensor,
                            project: bool = True) -> torch.Tensor:
        """Every token of the dual text tower [B, S, D] (`compute_text`
        keeps the first alone)."""
        x = self.text_model(input_ids, attention_mask)
        if project and self.txt_proj is not None:
            x = self.txt_proj(x)
        return x

    # ---------------- fused stack ----------------

    def video_unfused(self, video: Optional[torch.Tensor],
                      video_tokens: Optional[torch.Tensor] = None,
                      num_frames: Optional[int] = None) -> torch.Tensor:
        """Embed (fused-path CLS) + the first `num_unfused` video blocks."""
        f = self._num_frames(video, video_tokens, num_frames)
        v = self.video_model.embed(video, cls_token=self.cls_token,
                                   tokens=video_tokens)
        return self.video_model.run_blocks(v, f, start=0,
                                           end=self.cfg.num_unfused)

    def text_unfused(self, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor) -> torch.Tensor:
        """Embeddings + the first `num_unfused` text layers."""
        bias = make_additive_mask(attention_mask)
        t = self.text_model.embed(input_ids)
        return self.text_model.run_layers(t, bias, start=0,
                                          end=self.cfg.num_unfused)

    def fuse_from_unfused(self, v: torch.Tensor, t: torch.Tensor,
                          attention_mask: torch.Tensor,
                          num_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Lockstep fused blocks from the unfused intermediates. Text
        attends the PRE-update video tokens, then video advances.
        Returns (video_cls, text_tokens)."""
        bias = make_additive_mask(attention_mask)
        for i in range(self.cfg.num_unfused, self.cfg.text.num_layers):
            v_new = self.video_model.run_block(v, i, num_frames, text=t,
                                               text_bias=bias)
            t = self.text_model.run_layer(t, i, bias=bias, video=v,
                                          last_norm=True)
            v = v_new
        return self.norm(v)[:, 0], t

    def fused_encode(self, video: Optional[torch.Tensor],
                     input_ids: torch.Tensor, attention_mask: torch.Tensor,
                     video_tokens: Optional[torch.Tensor] = None,
                     num_frames: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unfused + fused lockstep stack.

        Returns (video_cls [B, Dv], text_tokens [B, St, Dt])."""
        f = self._num_frames(video, video_tokens, num_frames)
        v = self.video_unfused(video, video_tokens, f)
        t = self.text_unfused(input_ids, attention_mask)
        return self.fuse_from_unfused(v, t, attention_mask, f)

    def _itm_head_from(self, v_cls: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_cls = self.cross_modal_text_transform(t[:, 0])
        v_emb = self.cross_modal_video_transform(v_cls)
        cls_feats = torch.cat([self.cross_modal_text_pooler(t_cls),
                               self.cross_modal_video_pooler(v_emb)], dim=-1)
        return self.itm_score(cls_feats)

    def itm_forward(self, video: Optional[torch.Tensor],
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    video_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ITM logits [B, 2]."""
        v_cls, t = self.fused_encode(video, input_ids, attention_mask,
                                     video_tokens=video_tokens)
        return self._itm_head_from(v_cls, t)

    def mlm_forward(self, video: Optional[torch.Tensor],
                    mlm_input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    video_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MLM logits [B, St, vocab]."""
        _, t = self.fused_encode(video, mlm_input_ids, attention_mask,
                                 video_tokens=video_tokens)
        return self.mlm_score(self.cross_modal_text_transform(t))

    def _frames_from_unfused(self, v_un: torch.Tensor) -> int:
        return (v_un.shape[1] - 1) // self.cfg.video.patches_per_frame

    def mlm_forward_from_video(self, v_un: torch.Tensor,
                               mlm_input_ids: torch.Tensor,
                               attention_mask: torch.Tensor) -> torch.Tensor:
        """MLM logits from precomputed unfused video tokens. The video side
        of the fused paths is text-independent through the unfused blocks,
        so MLM and ITM can share one unfused-video pass."""
        f = self._frames_from_unfused(v_un)
        t = self.text_unfused(mlm_input_ids, attention_mask)
        _, t = self.fuse_from_unfused(v_un, t, attention_mask, f)
        return self.mlm_score(self.cross_modal_text_transform(t))

    def itm_forward_from_video(self, v_un: torch.Tensor,
                               input_ids: torch.Tensor,
                               attention_mask: torch.Tensor) -> torch.Tensor:
        """ITM logits from (already gathered) unfused video tokens."""
        f = self._frames_from_unfused(v_un)
        t = self.text_unfused(input_ids, attention_mask)
        v_cls, t = self.fuse_from_unfused(v_un, t, attention_mask, f)
        return self._itm_head_from(v_cls, t)

    def mlm_itm_forward_from_video(
            self, v_un_mlm: torch.Tensor, mlm_input_ids: torch.Tensor,
            mlm_attention_mask: torch.Tensor, v_un_itm: torch.Tensor,
            itm_input_ids: torch.Tensor, itm_attention_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """MLM + ITM fused stacks batched into one 2B-wide pass; examples
        are independent along the batch, so this equals the two separate
        passes. Returns (mlm_logits, itm_logits)."""
        b = v_un_mlm.shape[0]
        f = self._frames_from_unfused(v_un_mlm)
        v_un = torch.cat([v_un_mlm, v_un_itm], dim=0)
        ids = torch.cat([mlm_input_ids, itm_input_ids], dim=0)
        mask = torch.cat([mlm_attention_mask, itm_attention_mask], dim=0)
        t = self.text_unfused(ids, mask)
        v_cls, t = self.fuse_from_unfused(v_un, t, mask, f)
        mlm_logits = self.mlm_score(self.cross_modal_text_transform(t[:b]))
        itm_logits = self._itm_head_from(v_cls[b:], t[b:])
        return mlm_logits, itm_logits

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor):
        """Dual-encoder forward -> (text_embeds, video_embeds)."""
        return (self.compute_text(input_ids, attention_mask),
                self.compute_video(video))


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity matrix."""
    a, b = a.float(), b.float()
    a_n = torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=eps)
    b_n = torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=eps)
    return (a / a_n) @ (b / b_n).T


def sim_matrix_batch(a: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Batched cosine similarity [B, Na, D] x [B, Nb, D] -> [B, Na, Nb]."""
    a, b = a.float(), b.float()
    a_n = torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=eps)
    b_n = torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=eps)
    return torch.einsum("bnd,bmd->bnm", a / a_n, b / b_n)
