"""A third architecture, not EgoVLPv2, that the benchmark's tests add to a
copy of the benchmark as new files alone (`perfbench/tests/tiny.py` puts
this file at `perfbench/tasks/tiny_clip.py`): LaViLa's dual encoder in
small (Zhao et al., arXiv:2212.04501). A pre-LN divided space-time video
tower with CLIP's `ln_pre`, QuickGELU and a patch projection without bias;
a causal pre-LN text tower pooled at its end-of-text token; projections
without bias; InfoNCE with a learned logit scale. The module is defined
here, from the port's `Dense`, `LayerNorm` and divided attention, and runs
as the port's own training step; its reference is
`perfbench/reference/tiny_clip.py`."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.nn import functional as F

from perfbench import flops

REFERENCE = "tiny_clip"
LOGIT_SCALE = math.log(1 / 0.07)  # CLIP's start
NEG_INF = -1e9


def init_kind(name: str, shape) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    if name == "logit_scale":
        return "fill", LOGIT_SCALE
    if leaf == "bias" or (leaf == "weight" and len(shape) == 1):
        return ("zeros", 0.0) if leaf == "bias" else ("ones", 0.0)
    if "embedding" in name:
        return "normal", 0.02
    return "cut", math.sqrt(1.0 / shape[-1]) / 0.87962566103423978


def program_config(path: str):
    from egovlpv2_torch.core.config import OptimConfig

    with open(path) as f:
        raw = json.load(f)
    optim = OptimConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in raw["optim"].items()})
    return SimpleNamespace(model=SimpleNamespace(**raw["model"]),
                           optim=optim, log_grad_norm=False)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Mlp(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        from egovlpv2_torch.models.dense import Dense
        self.c_fc = Dense(d, 4 * d, dtype=dtype, device=device)
        self.c_proj = Dense(4 * d, d, dtype=dtype, device=device)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class VideoBlock(nn.Module):
    """x + time(ln_t(x)), + space(ln_1(x)), + mlp(ln_2(x))."""

    def __init__(self, d, heads, dtype, device):
        super().__init__()
        from egovlpv2_torch.models.dense import Dense
        from egovlpv2_torch.ops.layernorm import LayerNorm
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.ln_t, self.ln_1, self.ln_2 = (LayerNorm(d, **kw)
                                           for _ in range(3))
        self.qkv_t, self.proj_t = Dense(d, 3 * d, **kw), Dense(d, d, **kw)
        self.qkv, self.proj = Dense(d, 3 * d, **kw), Dense(d, d, **kw)
        self.mlp = Mlp(d, dtype, device)

    def attend(self, qkv, proj, x, axis, frames):
        from egovlpv2_torch.ops.divided import divided_attention
        b, s, d = x.shape
        dh = d // self.heads
        out = divided_attention(qkv(x).view(b, s, 3, self.heads, dh),
                                scale=dh ** -0.5, axis=axis,
                                num_frames=frames)
        return proj(out.reshape(b, s, d))

    def forward(self, x, frames):
        x = x + self.attend(self.qkv_t, self.proj_t, self.ln_t(x), "time",
                            frames)
        x = x + self.attend(self.qkv, self.proj, self.ln_1(x), "space",
                            frames)
        return x + self.mlp(self.ln_2(x))


class TextBlock(nn.Module):
    def __init__(self, d, heads, dtype, device):
        super().__init__()
        from egovlpv2_torch.models.dense import Dense
        from egovlpv2_torch.ops.layernorm import LayerNorm
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.ln_1, self.ln_2 = LayerNorm(d, **kw), LayerNorm(d, **kw)
        self.in_proj, self.out_proj = Dense(d, 3 * d, **kw), Dense(d, d, **kw)
        self.mlp = Mlp(d, dtype, device)

    def forward(self, x, causal):
        from egovlpv2_torch.ops.attention import attend_plain
        b, n, d = x.shape
        q, k, v = self.in_proj(self.ln_1(x)).view(
            b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        y = attend_plain(q, k, v, scale=(d // self.heads) ** -0.5,
                         bias=causal)
        x = x + self.out_proj(y.transpose(1, 2).reshape(b, n, d))
        return x + self.mlp(self.ln_2(x))


class TinyClip(nn.Module):
    def __init__(self, m, device=None):
        super().__init__()
        from egovlpv2_torch.models.dense import Dense
        from egovlpv2_torch.ops.layernorm import LayerNorm
        v, t = m.video, m.text
        dtype = getattr(torch, m.compute_dtype)
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.patch = dtype, v["patch_size"]
        n = (v["img_size"] // v["patch_size"]) ** 2
        d, w = v["width"], t["width"]
        self.conv1 = Dense(v["patch_size"] ** 2 * v["in_chans"], d,
                           bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.zeros(d, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(1 + n, d, device=device))
        self.temporal_embedding = nn.Parameter(
            torch.zeros(v["num_frames"], d, device=device))
        self.ln_pre, self.ln_post = LayerNorm(d, **kw), LayerNorm(d, **kw)
        self.blocks = nn.ModuleList(VideoBlock(d, v["heads"], dtype, device)
                                    for _ in range(v["layers"]))
        self.image_projection = Dense(d, m.embed_dim, bias=False, **kw)
        self.token_embedding = nn.Embedding(t["vocab_size"], w,
                                            device=device)
        self.text_positional_embedding = nn.Parameter(
            torch.zeros(t["context_length"], w, device=device))
        self.layers = nn.ModuleList(TextBlock(w, t["heads"], dtype, device)
                                    for _ in range(t["layers"]))
        self.ln_final = LayerNorm(w, **kw)
        self.text_projection = Dense(w, m.embed_dim, bias=False, **kw)
        self.logit_scale = nn.Parameter(torch.zeros((), device=device))

    def set_generator(self, generator):
        pass  # no dropout

    def encode_video(self, video):
        b, f, hh, ww, c = video.shape
        p = self.patch
        x = video.reshape(b, f, hh // p, p, ww // p, p, c).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(b, f * (hh // p) * (ww // p), -1)
        x = self.conv1(x)
        n = x.shape[1] // f
        pos = (self.positional_embedding[1:][None] + self.temporal_embedding[
            :, None]).reshape(f * n, -1)
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
        causal = torch.full((n, n), NEG_INF, device=ids.device).triu(1)
        for layer in self.layers:
            x = layer(x, causal)
        eot = mask.sum(1).long() - 1
        x = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        return self.text_projection(x)


def clip_loss(model, batch):
    v = F.normalize(model.encode_video(batch["video"]).float(), dim=-1)
    t = F.normalize(model.encode_text(batch["text_ids"],
                                      batch["text_mask"]).float(), dim=-1)
    logits = model.logit_scale.exp() * v @ t.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2
    return loss, {"loss_total": loss}


def build_model(cfg, device):
    return TinyClip(cfg.model, device=device)


def make_optimizer(cfg, model):
    """LaViLa's two groups: no decay for biases, norms and the scale."""
    from egovlpv2_torch.train.optimizer import make_schedule

    o = cfg.optim
    decay = [p for p in model.parameters() if p.dim() >= 2]
    rest = [p for p in model.parameters() if p.dim() < 2]
    optimizer = torch.optim.AdamW(
        [{"params": decay, "weight_decay": o.weight_decay},
         {"params": rest, "weight_decay": 0.0}],
        lr=o.lr, betas=o.betas, eps=o.eps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_schedule(o))


def make_step(model, cfg, optimizer, scheduler, generator, mining):
    from egovlpv2_torch.train.step import make_train_step
    return make_train_step(model, cfg, optimizer, scheduler, generator,
                           loss_fn=clip_loss)


def step_flops(cfg: dict, rows: int, traffic: dict) -> dict:
    """Every product of the forward, and the backward's two a product but
    for the patch projection's, whose input (the frames) takes none."""
    m = cfg["model"]
    v, t = m["video"], m["text"]
    f, d, w, e = v["num_frames"], v["width"], t["width"], m["embed_dim"]
    n = (v["img_size"] // v["patch_size"]) ** 2
    s, ln = 1 + f * n, cfg["max_text_len"]
    patch = flops.mm(rows * f * n, v["patch_size"] ** 2 * v["in_chans"], d)
    block = 2 * (flops.mm(rows * s, d, 3 * d) + flops.mm(rows * s, d, d)) \
        + 2 * flops.mm(rows * s, d, 4 * d) \
        + 4 * d * rows * ((s - 1) * (f + 1) + s + (s - 1) * (n + 1) + s)
    layer = flops.mm(rows * ln, w, 3 * w) + flops.mm(rows * ln, w, w) \
        + 2 * flops.mm(rows * ln, w, 4 * w) + 4 * w * rows * ln * ln
    fwd = patch + v["layers"] * block + t["layers"] * layer \
        + flops.mm(rows, d, e) + flops.mm(rows, w, e) \
        + flops.mm(rows, e, rows)
    return {"useful": 3 * fwd - patch, "recomputed": 0}


def step_calls(cfg: dict, rows: int, traffic: dict) -> list:
    """No call is counted: this task's rooflines read nothing."""
    return []
