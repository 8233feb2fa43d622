"""The plain reference of the third architecture of the benchmark's tests
(`perfbench/tests/tiny.py` puts this file at
`perfbench/reference/tiny_clip.py`): LaViLa's dual encoder in small, written
out again from the plain pieces of `perfbench/reference/model.py`, with
the program's parameter names; InfoNCE with a learned logit scale; and
LaViLa's AdamW groups (no decay for a parameter under two axes)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.model import (NEG_INF, LayerNorm, Linear, Precision,
                                       attention, divided_attention)

EPS = 1e-5


class Mlp(nn.Module):
    def __init__(self, prec, d):
        super().__init__()
        self.c_fc, self.c_proj = Linear(prec, d, 4 * d), Linear(prec, 4 * d, d)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))


class VideoBlock(nn.Module):
    def __init__(self, prec, d, heads):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.ln_t, self.ln_1, self.ln_2 = (LayerNorm(d, EPS) for _ in range(3))
        self.qkv_t, self.proj_t = Linear(prec, d, 3 * d), Linear(prec, d, d)
        self.qkv, self.proj = Linear(prec, d, 3 * d), Linear(prec, d, d)
        self.mlp = Mlp(prec, d)

    def attend(self, qkv, proj, x, axis, frames):
        b, s, d = x.shape
        dh = d // self.heads
        out = divided_attention(self.prec, qkv(x).view(b, s, 3, self.heads,
                                                       dh), dh ** -0.5, axis,
                                frames)
        return proj(out.reshape(b, s, d))

    def forward(self, x, frames):
        x = x + self.attend(self.qkv_t, self.proj_t, self.ln_t(x), "time",
                            frames)
        x = x + self.attend(self.qkv, self.proj, self.ln_1(x), "space",
                            frames)
        return x + self.mlp(self.ln_2(x))


class TextBlock(nn.Module):
    def __init__(self, prec, d, heads):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.ln_1, self.ln_2 = LayerNorm(d, EPS), LayerNorm(d, EPS)
        self.in_proj, self.out_proj = (Linear(prec, d, 3 * d),
                                       Linear(prec, d, d))
        self.mlp = Mlp(prec, d)

    def forward(self, x, causal):
        b, n, d = x.shape
        dh = d // self.heads
        q, k, v = self.in_proj(self.ln_1(x)).view(
            b, n, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        y = attention(self.prec, q, k, v, dh ** -0.5, bias=causal)
        x = x + self.out_proj(y.transpose(1, 2).reshape(b, n, d))
        return x + self.mlp(self.ln_2(x))


class TinyClip(nn.Module):
    def __init__(self, m: dict, prec: Precision, dtype=torch.float64):
        super().__init__()
        v, t = m["video"], m["text"]
        self.dtype, self.patch = dtype, v["patch_size"]
        n = (v["img_size"] // v["patch_size"]) ** 2
        d, w = v["width"], t["width"]
        self.conv1 = Linear(prec, v["patch_size"] ** 2 * v["in_chans"], d,
                            bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.positional_embedding = nn.Parameter(torch.zeros(1 + n, d))
        self.temporal_embedding = nn.Parameter(
            torch.zeros(v["num_frames"], d))
        self.ln_pre, self.ln_post = LayerNorm(d, EPS), LayerNorm(d, EPS)
        self.blocks = nn.ModuleList(VideoBlock(prec, d, v["heads"])
                                    for _ in range(v["layers"]))
        self.image_projection = Linear(prec, d, m["embed_dim"], bias=False)
        self.token_embedding = nn.Embedding(t["vocab_size"], w)
        self.text_positional_embedding = nn.Parameter(
            torch.zeros(t["context_length"], w))
        self.layers = nn.ModuleList(TextBlock(prec, w, t["heads"])
                                    for _ in range(t["layers"]))
        self.ln_final = LayerNorm(w, EPS)
        self.text_projection = Linear(prec, w, m["embed_dim"], bias=False)
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def encode_video(self, video):
        b, f, hh, ww, c = video.shape
        p = self.patch
        x = video.to(self.dtype).reshape(
            b, f, hh // p, p, ww // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.conv1(x.reshape(b, f * (hh // p) * (ww // p), -1))
        n = x.shape[1] // f
        pos = (self.positional_embedding[1:][None]
               + self.temporal_embedding[:, None]).reshape(f * n, -1)
        cls = self.class_embedding + self.positional_embedding[0]
        x = torch.cat([cls.to(x.dtype).expand(b, 1, -1),
                       x + pos.to(x.dtype)], dim=1)
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x, f)
        return self.image_projection(self.ln_post(x[:, 0]))

    def encode_text(self, ids, mask):
        n = ids.shape[1]
        x = (self.token_embedding(ids)
             + self.text_positional_embedding[:n]).to(self.dtype)
        causal = torch.full((n, n), NEG_INF, dtype=self.dtype,
                            device=ids.device).triu(1)
        for layer in self.layers:
            x = layer(x, causal)
        eot = mask.sum(1).long() - 1
        x = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        return self.text_projection(x)


def build(model_cfg: dict, precision: Precision) -> TinyClip:
    return TinyClip(model_cfg, precision)


def loss(model: TinyClip, batch, generator, cfg: dict) -> dict:
    v = F.normalize(model.encode_video(batch["video"]), dim=-1)
    t = F.normalize(model.encode_text(batch["text_ids"], batch["text_mask"]),
                    dim=-1)
    logits = model.logit_scale.to(v.dtype).exp() * v @ t.T
    i = torch.log_softmax(logits, dim=1)
    j = torch.log_softmax(logits.T, dim=1)
    return {"loss_total": -(torch.diag(i).mean() + torch.diag(j).mean()) / 2}


def group_of(name: str, ndim: int) -> str:
    return "backbone_wd" if ndim >= 2 else "backbone_nd"

