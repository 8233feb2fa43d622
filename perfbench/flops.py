"""Operations of one training step, counted from the configuration's
shapes and the paths the step takes, two operations a multiply-add.

`useful` is the step's work with nothing computed twice: every matrix
product of the forward, and of the backward the products for each input
that needs a gradient (a weight always; the video frames never). The
attention of a (query, key) pair is 4 Dh forward and 8 Dh backward.
`recomputed` is what the step computes again on top: the backward of the
fused i2t attention takes the logits a second time (2 Dh a pair). A block
whose output reaches no loss (the MLM path's last fused video block) runs
forward only.

Counted per path as `train/step.py` runs them (after
`scripts/mfu_accounting.py`, here parameterised by rows, frames and text
length): pre-training runs the dual towers for EgoNCE, one shared pass of
the unfused video blocks, and the fused stack twice (MLM on the masked
text, ITM on the mined rows); the dual fine-tune runs the two towers.
"""

from __future__ import annotations

from typing import Dict


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


class Shapes:
    """The widths of one configuration file's model at `rows` rows."""

    def __init__(self, cfg: dict, rows: int):
        v, t, fu = (cfg["model"]["video"], cfg["model"]["text"],
                    cfg["model"]["fusion"])
        self.b = rows
        self.f = v["num_frames"]
        self.n = (v["img_size"] // v["patch_size"]) ** 2
        self.s = 1 + self.f * self.n
        self.patch_in = v["patch_size"] ** 2 * v["in_chans"]
        self.d, self.hv = v["embed_dim"], v["num_heads"]
        self.dm = int(self.d * v["mlp_ratio"])
        self.depth = v["depth"]
        self.l = cfg["max_text_len"]
        self.dt, self.ht = t["hidden_size"], t["num_heads"]
        self.dti, self.vocab = t["intermediate_size"], t["vocab_size"]
        self.layers = t["num_layers"]
        self.fuse = fu["num_fuse_block"]
        self.hs = fu["hidden_size"]
        self.proj = cfg["model"]["projection"]
        self.p = cfg["model"]["projection_dim"]


def video_block(z: Shapes) -> int:
    b, s, d = z.b, z.s, z.d
    dh = d // z.hv
    linear = 2 * (mm(b * s, d, 3 * d) + mm(b * s, d, d)) \
        + mm(b * s, d, z.dm) + mm(b * s, z.dm, d)
    pairs_time = (s - 1) * (z.f + 1) + s  # patch rows + the CLS row
    pairs_space = (s - 1) * (z.n + 1) + s
    return linear + 4 * dh * b * z.hv * (pairs_time + pairs_space)


def i2t_linear(z: Shapes) -> int:
    """The fused video block's cross-attention products, attention aside."""
    b, s, d = z.b, z.s, z.d
    return mm(b * z.l, z.dt, 2 * d) + 2 * mm(b * s, d, d)


def i2t_pairs(z: Shapes) -> int:
    """(query, key) pairs times head dim of the i2t attention."""
    return z.b * z.hv * z.s * z.l * (z.d // z.hv)


def text_layer(z: Shapes, cross: bool) -> int:
    b, l, d = z.b, z.l, z.dt
    dh = d // z.ht
    ops = 4 * mm(b * l, d, d) + mm(b * l, d, z.dti) + mm(b * l, z.dti, d) \
        + 4 * dh * b * z.ht * l * l
    if cross:
        ops += 2 * mm(b * l, d, d) + 2 * mm(b * z.s, z.d, d) \
            + 4 * dh * b * z.ht * l * z.s
    return ops


def projection(z: Shapes, d_in: int) -> int:
    if z.proj == "minimal":
        return mm(z.b, d_in, z.p) + 2 * mm(z.b, z.p, z.p)
    return mm(z.b, d_in, z.p)


def patchify(z: Shapes) -> int:
    return mm(z.b * z.f * z.n, z.patch_in, z.d)


def dual_towers(z: Shapes) -> int:
    """Forward of both towers (no cross-attention), their projections and
    the similarity; the backward takes twice all but the patchify."""
    return z.layers * text_layer(z, False) + projection(z, z.dt) \
        + z.depth * video_block(z) + projection(z, z.d) + mm(z.b, z.p, z.b)


def fused_stack(z: Shapes) -> int:
    """Forward of one fused path: the unfused text layers and the fused
    depths (video block with i2t, text layer with t2i)."""
    unfused = z.layers - z.fuse
    return unfused * text_layer(z, False) + z.fuse * (
        video_block(z) + i2t_linear(z) + 4 * i2t_pairs(z)
        + text_layer(z, True))


def pretrain(cfg: dict, rows: int, noun_dim: int = 582,
             verb_dim: int = 118) -> Dict[str, int]:
    z = Shapes(cfg, rows)
    unfused_video = (z.depth - z.fuse) * video_block(z)
    mlm_head = mm(z.b * z.l, z.dt, z.hs) + mm(z.b * z.l, z.hs, z.hs) \
        + mm(z.b * z.l, z.hs, z.vocab)
    itm_head = mm(z.b, z.dt, z.hs) + mm(z.b, z.d, z.hs) \
        + 2 * mm(z.b, z.hs, z.hs) + mm(z.b, 2 * z.hs, 2)
    # the MLM path's last fused video block reaches no loss
    last_video = video_block(z) + i2t_linear(z) + 4 * i2t_pairs(z)
    differentiable = dual_towers(z) + unfused_video + 2 * fused_stack(z) \
        - last_video + mlm_head + itm_head
    forward_only = mm(z.b, noun_dim, z.b) + mm(z.b, verb_dim, z.b) \
        + last_video
    fwd = patchify(z) + differentiable + forward_only
    bwd = patchify(z) + 2 * differentiable
    i2t_backward = 2 * z.fuse - 1
    return {"useful": fwd + bwd,
            "recomputed": i2t_backward * 2 * i2t_pairs(z)}


def dual(cfg: dict, rows: int) -> Dict[str, int]:
    z = Shapes(cfg, rows)
    fwd = patchify(z) + dual_towers(z)
    bwd = patchify(z) + 2 * dual_towers(z)
    return {"useful": fwd + bwd, "recomputed": 0}
