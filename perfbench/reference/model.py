"""The plain reference of EgoVLPv2: TimeSformer-B/16 (divided space-time
attention) and RoBERTa-base with FIBER-style gated cross-attention in the
last blocks of each tower, the projections, and the ITM and MLM heads.

Plain PyTorch with no kernel, no cache and no fused operation: a frozen
copy of the semantics of the port's model code (EgoVLPv2, arXiv:2307.05463;
`EgoVLPv2/model/video_transformer.py`, `roberta.py`, `model.py`), written
out again and importing nothing of the port. The parameter names and
shapes are the port's, so one seeded draw fills both. Parameters are
float32, as the configuration keeps them; every operation computes in the
dtype of the activations, float64 for the reference, so that a gradient
that is nought but for rounding (the time attention's at its identity
start) reads as nought.

`Precision` decides how every matrix product is computed: exactly (the
reference), or in float8, e4m3 operands and results and e5m2 gradients,
one scale a tensor (the control, which stands for the step computed one
precision below the bfloat16 that the configuration states).

Random draws (dropout masks) come from the generator handed to
`set_generator`, in the order and shapes the port draws them, so that the
same generator gives both sides the same masks. Video blocks, which draw
nothing, are checkpointed one by one so that the reference fits at the
timed batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e9
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest


def _round(x: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """`x` rounded to `fp8` with one scale (its absolute maximum)."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8[fp8]
    return (x / scale).float().to(fp8).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """Forward: round to e4m3; backward: the gradient as it comes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """Forward: the product's result rounded to e4m3, as the program holds
    its results in its compute dtype; backward: its gradient rounded to
    e5m2, so that the backward's products take float8 operands too."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Precision:
    """How matrix products are computed: "exact" (as they are) or "fp8",
    as the program computes them in bfloat16 one precision lower: every
    operand and every result rounded to e4m3, every result's gradient to
    e5m2, each with one scale a tensor."""

    def __init__(self, kind: str = "exact"):
        if kind not in ("exact", "fp8"):
            raise ValueError(f"precision {kind!r}: exact or fp8")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand."""
        return x if self.kind == "exact" else _Operand.apply(x)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result."""
        return y if self.kind == "exact" else _Product.apply(y)


class Linear(nn.Module):
    """y = x W^T + b with W [out, in] float32, in x's dtype."""

    def __init__(self, prec: Precision, d_in: int, d_out: int,
                 bias: bool = True):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        y = self.prec.out(F.linear(self.prec(x),
                                   self.prec(self.weight.to(x.dtype))))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with the statistics as E[x^2] - E[x]^2 clipped at 0."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) \
            * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Dropout(nn.Module):
    """Keeps each element with probability 1 - rate, divided by it; the
    mask is one uniform draw of the input's shape."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def attention(prec: Precision, q, k, v, scale: float, bias=None,
              dropout: float = 0.0, generator=None):
    """softmax(scale q k^T + bias) v over the last two axes, the
    probabilities dropped at `dropout` (one uniform draw of their shape)."""
    logits = prec.out(torch.matmul(prec(q * scale),
                                   prec(k).transpose(-1, -2)))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        keep = 1.0 - dropout
        mask = torch.rand(probs.shape, device=probs.device,
                          generator=generator) < keep
        probs = torch.where(mask, probs / keep, torch.zeros_like(probs))
    return prec.out(torch.matmul(prec(probs), prec(v)))


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0, 1} -> [B, 1, 1, S]: 0 where kept, NEG_INF where padded."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def divided_attention(prec: Precision, qkv: torch.Tensor, scale: float,
                      axis: str, num_frames: int) -> torch.Tensor:
    """qkv [B, S, 3, H, Dh], S = 1 + F N, CLS first, frame-major patches.
    The CLS query attends all S keys; a patch query attends its frame
    (space) or its patch column (time) and the CLS key. -> [B, S, H, Dh]."""
    b, s, _, h, dh = qkv.shape
    f = num_frames
    n = (s - 1) // f
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, S, Dh]
    cls = attention(prec, q[:, :, :1], k, v, scale)

    def grouped(t):
        t = t[:, :, 1:].reshape(b, h, f, n, dh)
        return t.transpose(2, 3) if axis == "time" else t

    qg, kg, vg = grouped(q), grouped(k), grouped(v)
    g = qg.shape[2]
    kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, dh), kg], dim=3)
    vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, dh), vg], dim=3)
    out = attention(prec, qg, kg, vg, scale)
    if axis == "time":
        out = out.transpose(2, 3)
    out = out.reshape(b, h, f * n, dh)
    return torch.cat([cls, out], dim=2).transpose(1, 2)


class VideoAttention(nn.Module):
    def __init__(self, prec, c, axis: str, fused: bool):
        super().__init__()
        d = c["embed_dim"]
        bias = c["qkv_bias"]
        self.prec, self.axis, self.fused = prec, axis, fused
        self.h = c["num_heads"]
        self.dh = d // self.h
        self.qkv = Linear(prec, d, 3 * d, bias)
        self.proj = Linear(prec, d, d)
        if fused:
            self.qkv_text_i2t = Linear(prec, c["dim_text"], 2 * d, bias)
            self.norm_i2t_i = LayerNorm(d, c["ln_eps"])
            self.qkv_i2t = Linear(prec, d, d, bias)
            self.proj_i2t = Linear(prec, d, d)
            self.alpha_i2t = nn.Parameter(torch.zeros(1))

    def forward(self, x, num_frames, text=None, text_bias=None):
        b, s, d = x.shape
        h, dh = self.h, self.dh
        scale = dh ** -0.5
        qkv = self.qkv(x).view(b, s, 3, h, dh)
        x = self.proj(divided_attention(self.prec, qkv, scale, self.axis,
                                        num_frames).reshape(b, s, d))
        if self.fused and text is not None:
            st = text.shape[1]
            kv = self.qkv_text_i2t(text).view(b, st, 2, h, dh)
            kv = kv.permute(2, 0, 3, 1, 4)
            q = self.qkv_i2t(self.norm_i2t_i(x)).view(b, s, h, dh)
            y = attention(self.prec, q.transpose(1, 2), kv[0], kv[1], scale,
                          bias=text_bias)
            y = self.proj_i2t(y.transpose(1, 2).reshape(b, s, d))
            x = x + self.alpha_i2t.to(x.dtype) * y
        return x


class Mlp(nn.Module):
    def __init__(self, prec, d, hidden):
        super().__init__()
        self.fc1 = Linear(prec, d, hidden)
        self.fc2 = Linear(prec, hidden, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class VideoBlock(nn.Module):
    """x + space(norm1(x + time(norm3(x)))), then the MLP: the residual
    stream skips the time attention ('frozen-in-time')."""

    def __init__(self, prec, c, fused: bool):
        super().__init__()
        d, eps = c["embed_dim"], c["ln_eps"]
        self.norm3 = LayerNorm(d, eps)
        self.timeattn = VideoAttention(prec, c, "time", False)
        self.norm1 = LayerNorm(d, eps)
        self.attn = VideoAttention(prec, c, "space", fused)
        self.norm2 = LayerNorm(d, eps)
        self.mlp = Mlp(prec, d, int(d * c["mlp_ratio"]))

    def forward(self, x, num_frames, text=None, text_bias=None):
        t = self.timeattn(self.norm3(x), num_frames)
        s = self.attn(self.norm1(x + t), num_frames, text, text_bias)
        r = x + s
        return r + self.mlp(self.norm2(r))


class PatchEmbed(nn.Module):
    """Stride-p patches as one product; `weight` is [p, p, C, D] and the
    patches are flattened in (p, p, C) order."""

    def __init__(self, prec, c):
        super().__init__()
        p, ch, d = c["patch_size"], c["in_chans"], c["embed_dim"]
        self.prec, self.p = prec, p
        self.weight = nn.Parameter(torch.zeros(p, p, ch, d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):  # [BF, H, W, C] -> [BF, N, D]
        p = self.p
        bf, hh, ww, c = x.shape
        x = x.reshape(bf, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(bf, (hh // p) * (ww // p), p * p * c)
        w = self.weight.reshape(p * p * c, -1).to(x.dtype)
        return self.prec.out(torch.matmul(self.prec(x), self.prec(w))) \
            + self.bias.to(x.dtype)


class VideoTower(nn.Module):
    def __init__(self, prec, c, num_fuse: int, checkpointed: bool, dtype):
        super().__init__()
        d = c["embed_dim"]
        self.c, self.dtype = c, dtype
        self.n = (c["img_size"] // c["patch_size"]) ** 2
        self.checkpointed = checkpointed
        self.patch_embed = PatchEmbed(prec, c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n + 1, d))
        self.temporal_embed = nn.Parameter(
            torch.zeros(1, c["num_frames"], d))
        unfused = c["depth"] - num_fuse
        self.blocks = nn.ModuleList(VideoBlock(prec, c, i >= unfused)
                                    for i in range(c["depth"]))
        self.norm = LayerNorm(d, c["ln_eps"])

    def patchify(self, video):  # [B, F, H, W, C] -> [B, F N, D]
        b, f, hh, ww, ch = video.shape
        x = self.patch_embed(video.reshape(b * f, hh, ww, ch).to(self.dtype))
        return x.reshape(b, f * self.n, -1)

    def embed(self, tokens, cls_token=None):
        b = tokens.shape[0]
        cls = (self.cls_token if cls_token is None else cls_token)
        x = torch.cat([cls.to(tokens.dtype).expand(b, 1, -1), tokens], dim=1)
        pos = torch.cat([
            self.pos_embed[:, :1],
            self.pos_embed[:, 1:].repeat(1, self.c["num_frames"], 1)
            + self.temporal_embed.repeat_interleave(self.n, dim=1)], dim=1)
        return x + pos[:, :x.shape[1]].to(x.dtype)

    def run_block(self, x, i, num_frames, text=None, text_bias=None):
        blk = self.blocks[i]
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(blk, x, num_frames, text, text_bias,
                              use_reentrant=False)
        return blk(x, num_frames, text, text_bias)

    def run_blocks(self, x, num_frames, start=0, end=None):
        for i in range(start, self.c["depth"] if end is None else end):
            x = self.run_block(x, i, num_frames)
        return x


class TextAttention(nn.Module):
    """Q from text; K and V from text (self) or from video tokens (cross)."""

    def __init__(self, prec, c, kv_dim: Optional[int] = None):
        super().__init__()
        d = c["hidden_size"]
        kv = kv_dim or d
        self.prec, self.h = prec, c["num_heads"]
        self.scale = (d // self.h) ** -0.5
        self.p_attn = c["attn_dropout"]
        self.generator = None
        self.query = Linear(prec, d, d)
        self.key = Linear(prec, kv, d)
        self.value = Linear(prec, kv, d)
        self.out_dense = Linear(prec, d, d)
        self.drop = Dropout(c["hidden_dropout"])

    def heads(self, x):
        b, s, d = x.shape
        return x.reshape(b, s, self.h, d // self.h).transpose(1, 2)

    def forward(self, hidden, kv_source, bias=None):
        out = attention(self.prec, self.heads(self.query(hidden)),
                        self.heads(self.key(kv_source)),
                        self.heads(self.value(kv_source)), self.scale, bias,
                        self.p_attn if self.training else 0.0, self.generator)
        b, h, s, dh = out.shape
        return self.drop(self.out_dense(out.transpose(1, 2).reshape(
            b, s, h * dh)))


class TextLayer(nn.Module):
    """Post-LN over (self + alpha_t2i cross + residual), then the FFN."""

    def __init__(self, prec, c, fused: bool, dim_video: int):
        super().__init__()
        d, eps = c["hidden_size"], c["ln_eps"]
        self.fused = fused
        self.attention = TextAttention(prec, c)
        if fused:
            self.crossattention_t2i = TextAttention(prec, c, dim_video)
            self.alpha_t2i = nn.Parameter(torch.zeros(1))
        self.attention_LayerNorm = LayerNorm(d, eps)
        self.intermediate = Linear(prec, d, c["intermediate_size"])
        self.output = Linear(prec, c["intermediate_size"], d)
        self.output_LayerNorm = LayerNorm(d, eps)
        self.drop = Dropout(c["hidden_dropout"])

    def forward(self, hidden, bias=None, video=None, last_norm=True):
        a = self.attention(hidden, hidden, bias)
        if self.fused and video is not None:
            a = self.alpha_t2i.to(a.dtype) * self.crossattention_t2i(
                a, video) + a
        a = self.attention_LayerNorm(a + hidden)
        out = self.drop(self.output(F.gelu(self.intermediate(a)))) + a
        return self.output_LayerNorm(out) if last_norm else out


class TextEmbeddings(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        d = c["hidden_size"]
        self.dtype = dtype
        self.pad = c["pad_token_id"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], d)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"],
                                                d)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], d)
        self.LayerNorm = LayerNorm(d, c["ln_eps"])
        self.drop = Dropout(c["hidden_dropout"])

    def forward(self, ids):
        keep = (ids != self.pad).long()
        pos = torch.cumsum(keep, dim=1) * keep + self.pad
        x = self.word_embeddings(ids) + self.token_type_embeddings(
            torch.zeros_like(ids)) + self.position_embeddings(pos)
        return self.drop(self.LayerNorm(x.to(self.dtype)))


class TextTower(nn.Module):
    def __init__(self, prec, c, num_fuse: int, dim_video: int, dtype):
        super().__init__()
        self.c = c
        self.embeddings = TextEmbeddings(c, dtype)
        unfused = c["num_layers"] - num_fuse
        self.layer = nn.ModuleList(TextLayer(prec, c, i >= unfused, dim_video)
                                   for i in range(c["num_layers"]))

    def run_layers(self, hidden, bias, start=0, end=None):
        for i in range(start, self.c["num_layers"] if end is None else end):
            hidden = self.layer[i](hidden, bias)
        return hidden


class ProjMinimal(nn.Module):
    """Linear (no bias) -> ReLU -> Linear -> ReLU -> Linear."""

    def __init__(self, prec, d_in, d):
        super().__init__()
        self.fc0 = Linear(prec, d_in, d, bias=False)
        self.fc1 = Linear(prec, d, d)
        self.fc2 = Linear(prec, d, d)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(torch.relu(self.fc0(x)))))


class ProjSmall(nn.Module):
    """[ReLU ->] Linear."""

    def __init__(self, prec, d_in, d, relu_first):
        super().__init__()
        self.relu_first = relu_first
        self.fc0 = Linear(prec, d_in, d)

    def forward(self, x):
        return self.fc0(torch.relu(x) if self.relu_first else x)


class Pooler(nn.Module):
    def __init__(self, prec, d):
        super().__init__()
        self.dense = Linear(prec, d, d)

    def forward(self, x):
        return torch.tanh(self.dense(x))


class ITMHead(nn.Module):
    def __init__(self, prec, d_in):
        super().__init__()
        self.fc = Linear(prec, d_in, 2)

    def forward(self, x):
        return self.fc(x)


class MLMHead(nn.Module):
    def __init__(self, prec, d, vocab):
        super().__init__()
        self.transform_dense = Linear(prec, d, d)
        self.transform_LayerNorm = LayerNorm(d, 1e-12)
        self.decoder = Linear(prec, d, vocab, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab))

    def forward(self, x):
        logits = self.decoder(self.transform_LayerNorm(
            F.gelu(self.transform_dense(x))))
        return logits + self.bias.to(logits.dtype)


class EgoVLPv2(nn.Module):
    """`model` is the configuration file's "model" group, every key
    stated; `dtype` the activations' (and every operation's)."""

    def __init__(self, model: dict, prec: Precision,
                 checkpointed: bool = True, dtype=torch.float64):
        super().__init__()
        v, t, fu = model["video"], model["text"], model["fusion"]
        vc = dict(v, dim_text=fu["dim_text"])
        nf = fu["num_fuse_block"]
        self.m = model
        self.num_unfused = t["num_layers"] - nf
        self.video_model = VideoTower(prec, vc, nf, checkpointed, dtype)
        self.text_model = TextTower(prec, t, nf, fu["dim_video"], dtype)
        dv, dt, dp = v["embed_dim"], t["hidden_size"], model["projection_dim"]
        if model["projection"] == "minimal":
            self.txt_proj = ProjMinimal(prec, dt, dp)
            self.vid_proj = ProjMinimal(prec, dv, dp)
        elif model["projection"] == "small":
            self.txt_proj = ProjSmall(prec, dt, dp, True)
            self.vid_proj = ProjSmall(prec, dv, dp, False)
        else:
            raise ValueError(f"projection {model['projection']!r}")
        if model["with_itm_head"] or model["with_mlm_head"]:
            hs = fu["hidden_size"]
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dv))
            self.norm = LayerNorm(dv, fu["ln_eps"])
            self.cross_modal_text_transform = Linear(prec, dt, hs)
            self.cross_modal_video_transform = Linear(prec, dv, hs)
            self.cross_modal_text_pooler = Pooler(prec, hs)
            self.cross_modal_video_pooler = Pooler(prec, hs)
        if model["with_itm_head"]:
            self.itm_score = ITMHead(prec, 2 * fu["hidden_size"])
        if model["with_mlm_head"]:
            self.mlm_score = MLMHead(prec, fu["hidden_size"], t["vocab_size"])

    def set_generator(self, generator):
        for module in self.modules():
            if hasattr(module, "generator"):
                module.generator = generator

    def frames(self, tokens) -> int:
        return tokens.shape[1] // self.video_model.n

    def compute_video(self, tokens):
        x = self.video_model.embed(tokens)
        x = self.video_model.run_blocks(x, self.frames(tokens))
        return self.vid_proj(self.video_model.norm(x)[:, 0])

    def compute_text(self, ids, mask):
        x = self.text_model.run_layers(self.text_model.embeddings(ids),
                                       additive_mask(mask))
        return self.txt_proj(x[:, 0])

    def video_unfused(self, tokens):
        v = self.video_model.embed(tokens, cls_token=self.cls_token)
        return self.video_model.run_blocks(v, self.frames(tokens), 0,
                                           self.num_unfused)

    def fused(self, v_un, ids, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unfused text layers, then the fused depths in lockstep: text
        attends the video tokens from before each depth's update.
        -> (video CLS after the final norm, text tokens)."""
        f = (v_un.shape[1] - 1) // self.video_model.n
        bias = additive_mask(mask)
        t = self.text_model.run_layers(self.text_model.embeddings(ids), bias,
                                       0, self.num_unfused)
        v = v_un
        for i in range(self.num_unfused, self.m["text"]["num_layers"]):
            v_new = self.video_model.run_block(v, i, f, t, bias)
            t = self.text_model.layer[i](t, bias, video=v)
            v = v_new
        return self.norm(v)[:, 0], t

    def mlm_logits(self, v_un, mlm_ids, mask):
        _, t = self.fused(v_un, mlm_ids, mask)
        return self.mlm_score(self.cross_modal_text_transform(t))

    def itm_logits(self, v_un, ids, mask):
        v_cls, t = self.fused(v_un, ids, mask)
        t_cls = self.cross_modal_text_transform(t[:, 0])
        v_emb = self.cross_modal_video_transform(v_cls)
        return self.itm_score(torch.cat([
            self.cross_modal_text_pooler(t_cls),
            self.cross_modal_video_pooler(v_emb)], dim=-1))


def sim_matrix(a, b, eps: float = 1e-8):
    a_n = torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=eps)
    b_n = torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=eps)
    return (a / a_n) @ (b / b_n).T
