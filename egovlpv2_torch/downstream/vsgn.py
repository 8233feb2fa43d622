"""VSGN temporal action detection head for EgoMQ (port of
`egovlpv2_tpu/downstream/vsgn.py`).

Capability-parity targets (all under `EgoMQ/Models/`):
  * XGPN.py — conv0 + encoder pyramid (stride-2 xGN blocks) + transposed-conv
    decoder with lateral connections;
  * GCNs.py — xGN = temporal conv branch + NeighConv graph conv over kNN
    (feature-distance) neighbors, incl. the VSS stitched-video neighbor
    rewrite expressed with masks instead of per-sample loops;
  * Head.py — shared cls/reg towers (conv + GroupNorm(32) + ReLU) with
    per-level anchor logits;
  * AnchorGenerator.py / BoxCoder.py — 1-D anchors per pyramid level,
    (dx, dw)-style encode/decode with (10, 5) weights;
  * matcher.py / Loss.py — IoU argmax matching with low-quality recovery,
    pos/neg-balanced CE + GIoU regression, weighted-BCE supplement scores;
  * BoundaryAdjust.py — second-stage start/end offsets from frame-level
    features at (left, center, right) boundary probes.

Sequences are channels-last [B, T, C] between modules, as in the JAX
package; each convolution transposes to PyTorch's [B, C, T] and back. The
parameters carry the flax tree's names (`weights.py`): a flax module name
`enc_0` is the list entry `enc.0`, and `ConvRelu`'s auto-named `Conv_0` is
`Conv.0`. The head is float32 and runs no hand-written kernel: its
convolutions, GroupNorm and graph gather are plain PyTorch, as they are
plain XLA in the reference.

Two places differ in form from the JAX code, not in result:
  * `knn_indices` takes the squared distances a block of rows at a time
    under `torch.no_grad()` (the JAX form materialises [B, T, T, C], 14 GB
    at B=16, T=928, C=256) and picks the k nearest with a stable sort, so
    ties go to the lower index as `lax.top_k`'s do;
  * flax's `ConvTranspose(3, strides=2, padding="SAME")` does not flip its
    kernel: it is `conv_transpose1d` with the taps reversed (the weight
    bridge reverses them), no padding, and the first 2T of 2T + 1 outputs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from egovlpv2_torch.models.dense import Dense

# Rows of the [B, rows, T, C] difference block of `knn_indices`, as many as
# keep it near this many float32 elements (64 M, 256 MB).
_KNN_BLOCK_ELEMENTS = 1 << 26


# ---------------- anchors ----------------


def make_anchors(
    temporal_scale: int,
    num_levels: int,
    anchor_scales: Sequence[float],
    base_stride: int = 1,
) -> List[np.ndarray]:
    """Per-level [positions*scales, 2] anchors (AnchorGenerator.py:12-66)."""
    out = []
    for lvl in range(num_levels):
        stride = base_stride * (2 ** lvl)
        base = np.array([1.0, stride]) - 0.5
        length = base[1] - base[0] + 1
        center = base[0] + 0.5 * (length - 1)
        ws = length * np.asarray(anchor_scales, np.float32)
        base_anchors = np.stack(
            [center - 0.5 * (ws - 1), center + 0.5 * (ws - 1)], axis=1
        )  # [S, 2]
        size = math.ceil(temporal_scale / stride)
        shifts = np.arange(0, size * stride, step=stride, dtype=np.float32)
        shifts = np.stack([shifts, shifts], axis=1)  # [P, 2]
        anchors = (shifts[:, None, :] + base_anchors[None]).reshape(-1, 2)
        out.append(anchors.astype(np.float32))
    return out


def box_encode(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(dx, dw) encode with weights (10, 5) (BoxCoder.py:encode)."""
    ex_len = anchors[..., 1] - anchors[..., 0] + 1
    ex_ctr = (anchors[..., 1] + anchors[..., 0]) / 2
    gt_len = gt[..., 1] - gt[..., 0] + 1
    gt_ctr = (gt[..., 1] + gt[..., 0]) / 2
    dx = 10.0 * (gt_ctr - ex_ctr) / ex_len
    dw = 5.0 * torch.log(torch.clamp(gt_len / ex_len, min=1e-8))
    return torch.stack([dx, dw], dim=-1)


def box_decode(preds: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    ex_len = anchors[..., 1] - anchors[..., 0] + 1
    ex_ctr = (anchors[..., 1] + anchors[..., 0]) / 2
    dx = preds[..., 0] / 10.0
    dw = torch.clamp(preds[..., 1] / 5.0, max=math.log(1000.0 / 16))
    ctr = dx * ex_len + ex_ctr
    w = torch.exp(dw) * ex_len
    return torch.stack([ctr - 0.5 * (w - 1), ctr + 0.5 * (w - 1)], dim=-1)


# ---------------- matching ----------------


def iou_anchors_gts(anchors: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """[A, 2] x [..., G, 2] -> [..., A, G] (Loss.py:_iou_anchors_gts; note
    the +1 length convention)."""
    a_min, a_max = anchors[:, 0, None], anchors[:, 1, None]
    g_min, g_max = gts[..., None, :, 0], gts[..., None, :, 1]
    len_a = a_max - a_min + 1
    inter = torch.clamp(torch.minimum(a_max, g_max) - torch.maximum(a_min, g_min),
                        min=0)
    union = torch.clamp(len_a + g_max - g_min - inter, min=0)
    return inter / torch.clamp(union, min=1e-8)


def match_anchors(
    iou: torch.Tensor,  # [..., A, G]
    gt_valid: torch.Tensor,  # [..., G] bool
    iou_thr: float,
    allow_low_quality: bool = True,
) -> torch.Tensor:
    """Per-anchor matched gt index or -1 (matcher.py semantics); argmax takes
    the first of equal values, as jnp.argmax does."""
    valid = gt_valid[..., None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, -1.0))
    matched_vals = iou.max(dim=-1).values
    matches_all = iou.argmax(dim=-1)
    matches = torch.where(matched_vals < iou_thr,
                          torch.full_like(matches_all, -1), matches_all)
    if allow_low_quality:
        highest_per_gt = iou.max(dim=-2, keepdim=True).values  # [..., 1, G]
        is_top = ((iou == highest_per_gt) & valid & (highest_per_gt > 0)).any(-1)
        matches = torch.where(is_top, matches_all, matches)
    return matches


def prepare_targets(
    gt_bbox: torch.Tensor,  # [B, Gmax, 3] (start, end in [0,1], label)
    num_gt: torch.Tensor,  # [B]
    anchors: torch.Tensor,  # [A, 2]
    temporal_scale: float,
    iou_thr: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> cls labels [B, A] (0 = bg), reg targets [B, A, 2] (Loss.py:142-172),
    for the whole batch at once."""
    gts = gt_bbox[..., :2] * temporal_scale  # [B, G, 2]
    labels = gt_bbox[..., 2]
    valid = torch.arange(gt_bbox.shape[1], device=gt_bbox.device) \
        < num_gt[:, None]
    matched = match_anchors(iou_anchors_gts(anchors, gts), valid, iou_thr)
    picked = torch.clamp(matched, min=0)  # [B, A]
    cls = torch.where(matched < 0, torch.zeros_like(labels[:, :1]),
                      torch.gather(labels, 1, picked))
    matched_gt = torch.gather(gts, 1, picked[..., None].expand(-1, -1, 2))
    reg = box_encode(matched_gt, anchors)
    return cls.to(torch.int32), reg


# ---------------- losses ----------------


def balanced_ce_loss(cls_pred: torch.Tensor, cls_labels: torch.Tensor
                     ) -> torch.Tensor:
    """pos-mean + neg-mean CE (Loss.py:86-104)."""
    logp = torch.log_softmax(cls_pred.float(), dim=-1)
    ce = -torch.gather(logp, 1, cls_labels.long()[:, None])[:, 0]
    pmask = (cls_labels > 0).float()
    nmask = (cls_labels == 0).float()
    pos = torch.sum(ce * pmask) / torch.clamp(pmask.sum(), min=1.0)
    neg = torch.sum(ce * nmask) / torch.clamp(nmask.sum(), min=1.0)
    return pos + neg


def giou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """sum of (1 - GIoU) over weighted rows / sum(weights) (Loss.py:106-139)."""
    p1 = torch.minimum(pred_boxes[:, 0], pred_boxes[:, 1])
    p2 = torch.maximum(pred_boxes[:, 0], pred_boxes[:, 1])
    t1, t2 = target_boxes[:, 0], target_boxes[:, 1]
    inter = torch.clamp(torch.minimum(p2, t2) - torch.maximum(p1, t1), min=0)
    enclosing = torch.maximum(p2, t2) - torch.minimum(p1, t1) + 1e-7
    union = (p2 - p1) + (t2 - t1) - inter + 1e-7
    giou = inter / union - (enclosing - union) / enclosing
    return torch.sum((1.0 - giou) * weights) / torch.clamp(weights.sum(),
                                                           min=1.0)


def weighted_bi_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Class-balanced BCE on sigmoid scores (Loss.py:175-192)."""
    gt = gt.reshape(-1)
    pred = pred.reshape(-1)
    pmask = (gt > 0.5).float()
    num_pos = torch.clamp(pmask.sum(), min=1.0)
    ratio = gt.shape[0] / num_pos
    coef_0 = 0.5 * ratio / torch.clamp(ratio - 1, min=1e-5)
    coef_1 = coef_0 * (ratio - 1)
    loss = coef_1 * pmask * torch.log(pred + 1e-5) + \
        coef_0 * (1.0 - pmask) * torch.log(1.0 - pred + 1e-5)
    return -torch.mean(loss)


# ---------------- modules ----------------


class Conv(nn.Conv1d):
    """flax `nn.Conv` (stride 1) over channels-last [B, T, C]: "SAME" pads
    k - 1 zeros, the odd one at the end; "VALID" pads none. `weight` is
    [out, in / groups, k]."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 padding: str = "SAME", groups: int = 1, bias: bool = True,
                 device=None):
        super().__init__(in_features, features, kernel, groups=groups,
                         bias=bias, device=device)
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        if self.same:
            pad = self.kernel_size[0] - 1
            x = F.pad(x, (pad // 2, pad - pad // 2))
        return super().forward(x).transpose(1, 2)


class ConvTransposeSame(nn.ConvTranspose1d):
    """flax `nn.ConvTranspose(k, strides=2, padding="SAME")` over
    channels-last [B, T, C] -> [B, 2T, C]. `weight` is [in, out, k], the
    flax kernel's taps reversed (flax does not flip them)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 device=None):
        super().__init__(in_features, features, kernel, stride=2,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        y = super().forward(x.transpose(1, 2))  # [B, C, 2T + 1]
        return y[..., :2 * t].transpose(1, 2)


class NeighConv(nn.Module):
    """Graph conv over kNN neighbors (GCNs.py:53-90) in the reference's
    default mode, the one every caller takes: [neighbour, centre] features,
    edge weights, max aggregation."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.mlp = Dense(2 * in_features, out_features, device=device)

    def forward(self, feats: torch.Tensor, neigh_idx: torch.Tensor
                ) -> torch.Tensor:
        """feats [B, T, C]; neigh_idx [B, T, K] into T."""
        batch = torch.arange(feats.shape[0], device=feats.device)
        nb = feats[batch[:, None, None], neigh_idx]  # [B, T, K, C]
        ctr = feats[:, :, None, :].expand_as(nb)
        out = self.mlp(torch.cat([nb, ctr], dim=-1))  # [B, T, K, C']
        num = torch.einsum("btkc,btc->btk", nb, feats)
        den = torch.linalg.vector_norm(nb, dim=-1) * \
            torch.linalg.vector_norm(feats, dim=-1)[:, :, None]
        out = out * (num / torch.clamp(den, min=1e-8))[..., None]
        return out.max(dim=2).values


def _k_nearest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of each row, ties to the lower index (a
    stable sort), as `lax.top_k(-dist, k)`."""
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


@torch.no_grad()
def knn_indices(
    feats: torch.Tensor,  # [B, T, C]
    k: int,
    num_frms: Optional[torch.Tensor] = None,
    temporal_scale: Optional[int] = None,
    stitch_gap: int = 30,
    short_ratio: float = 0.4,
    use_vss: bool = False,
) -> torch.Tensor:
    """kNN by squared feature distance (GCNs.py:13-41). With use_vss, short
    stitched videos re-pick the second half of the neighbors outside the
    first-stage picks and outside the beyond-video region — expressed with
    masks rather than per-sample index surgery. The distances are the JAX
    code's sums of squared differences, a block of rows at a time."""
    b, t, c = feats.shape
    rows = max(1, min(t, _KNN_BLOCK_ELEMENTS // max(b * t * c, 1)))
    dif = torch.empty((b, t, t), dtype=feats.dtype, device=feats.device)
    for lo in range(0, t, rows):
        block = feats[:, lo:lo + rows, None, :] - feats[:, None, :, :]
        dif[:, lo:lo + rows] = (block * block).sum(-1)
        del block
    idx_org = _k_nearest(dif, k)
    if not use_vss or num_frms is None:
        return idx_org

    max_dif = dif.max()
    ratio = temporal_scale / t
    half1 = k // 2
    half2 = k - half1
    thr = ((num_frms + stitch_gap) / ratio).to(torch.int32)  # [B]
    is_short = num_frms <= (short_ratio * temporal_scale)
    pos = torch.arange(t, device=feats.device)
    beyond = (pos[None, :, None] >= thr[:, None, None]) & \
             (pos[None, None, :] >= thr[:, None, None])  # [B, T, T]
    taken = torch.zeros((b, t, t), dtype=torch.bool, device=feats.device)
    taken.scatter_(2, idx_org[..., :half1], True)
    dif2 = torch.where(beyond | taken, max_dif + 1, dif)
    idx_new = torch.cat([idx_org[..., :half1], _k_nearest(dif2, half2)], dim=-1)
    return torch.where(is_short[:, None, None], idx_new, idx_org)


class XGN(nn.Module):
    """Temporal conv + parallel graph conv + optional stride-2 maxpool
    (GCNs.py:92-130, gcn_insert='par')."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 num_neigh: int = 10, use_vss: bool = False,
                 temporal_scale: int = 928, stitch_gap: int = 30,
                 short_ratio: float = 0.4, device=None):
        super().__init__()
        self.stride, self.num_neigh, self.use_vss = stride, num_neigh, use_vss
        self.temporal_scale = temporal_scale
        self.stitch_gap, self.short_ratio = stitch_gap, short_ratio
        self.tconv1 = Conv(in_channels, out_channels, 3, device=device)
        self.nconv1 = NeighConv(in_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor, num_frms: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        # x: [B, T, C] channels-last
        c_out = self.tconv1(x)
        idx = knn_indices(x, self.num_neigh, num_frms, self.temporal_scale,
                          self.stitch_gap, self.short_ratio, self.use_vss)
        out = torch.relu(c_out + self.nconv1(x, idx))
        if self.stride == 2:
            out = F.max_pool1d(out.transpose(1, 2), 2).transpose(1, 2)
        return out


class ConvRelu(nn.Module):
    """relu(Conv) with the flax auto-name of its conv, `Conv_0`."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 device=None):
        super().__init__()
        self.Conv = nn.ModuleList([Conv(in_features, features, kernel,
                                        device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Conv[0](x))


class XGPN(nn.Module):
    """Encoder/decoder cross-scale pyramid (XGPN.py:12-108), its encoder
    levels xGN blocks (`use_xgpn=True`, the one setting any caller takes)."""

    def __init__(self, input_feat_dim: int, hidden_dim: int = 256,
                 num_levels: int = 5, use_vss: bool = False,
                 temporal_scale: int = 928, num_neigh: int = 10, device=None):
        super().__init__()
        self.conv0 = ConvRelu(input_feat_dim, hidden_dim, device=device)
        self.enc = nn.ModuleList([
            XGN(hidden_dim, hidden_dim, stride=1 if i == 0 else 2,
                num_neigh=num_neigh, use_vss=use_vss,
                temporal_scale=temporal_scale, device=device)
            for i in range(num_levels)])
        self.lvl1 = nn.ModuleList([ConvRelu(hidden_dim, hidden_dim,
                                            device=device)
                                   for _ in range(num_levels)])
        self.lvl2 = nn.ModuleList([ConvRelu(hidden_dim, hidden_dim,
                                            device=device)
                                   for _ in range(num_levels - 1)])
        self.dec = nn.ModuleList([ConvTransposeSame(hidden_dim, hidden_dim,
                                                    device=device)
                                  for _ in range(num_levels - 1)])

    def forward(self, x: torch.Tensor, num_frms: Optional[torch.Tensor] = None):
        x = self.conv0(x)
        feats_enc = []
        for enc in self.enc:
            x = enc(x, num_frms)
            feats_enc.append(x)

        n = len(self.enc)
        y = self.lvl1[0](feats_enc[-1])
        feats_dec = [y]
        for i in range(n - 1):
            lateral = self.lvl2[i](feats_enc[n - i - 2])
            up = torch.relu(self.dec[i](y))[:, :lateral.shape[1]]
            y = self.lvl1[i + 1](lateral + up)
            feats_dec.append(y)
        return feats_enc, feats_dec


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups)` over channels-last [B, T, C]: the
    statistics over (T, C / G) in float32 as E[x^2] - E[x]^2 clipped at 0,
    eps 1e-6; `weight` is flax's `scale`."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        g = x.float().reshape(b, t, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean,
                          min=0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight + self.bias).to(x.dtype)


class DetectionHead(nn.Module):
    """Shared cls/reg towers over pyramid levels (Head.py)."""

    def __init__(self, hidden_dim: int, num_anchors: int, num_classes: int,
                 num_convs: int = 1, device=None):
        super().__init__()

        def tower(kind):
            return nn.ModuleList([kind() for _ in range(num_convs)])

        conv = lambda: Conv(hidden_dim, hidden_dim, 3, device=device)
        norm = lambda: GroupNorm(hidden_dim, 32, device=device)
        self.cls_conv, self.cls_gn = tower(conv), tower(norm)
        self.box_conv, self.box_gn = tower(conv), tower(norm)
        self.cls_logits = Conv(hidden_dim, num_anchors * num_classes, 3,
                               device=device)
        self.bbox_pred = Conv(hidden_dim, num_anchors * 2, 3, device=device)

    def forward(self, feats: List[torch.Tensor]):
        logits, regs = [], []
        for f in feats:
            c = f
            for conv, gn in zip(self.cls_conv, self.cls_gn):
                c = torch.relu(gn(conv(c)))
            b = f
            for conv, gn in zip(self.box_conv, self.box_gn):
                b = torch.relu(gn(conv(b)))
            logits.append(self.cls_logits(c))  # [B, T_l, A*num_cls]
            regs.append(self.bbox_pred(b))  # [B, T_l, A*2]
        return logits, regs


def linear_resize(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """1-D linear interpolation with align_corners=True (VSGN.py:88-90)."""
    in_len = x.shape[-1]
    pos = torch.linspace(0.0, in_len - 1, out_len, device=x.device)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_len - 1)
    w = pos - lo
    return x[..., lo] * (1 - w) + x[..., hi] * w


class ScoreHead(nn.Module):
    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.conv1 = Conv(hidden_dim, hidden_dim, 3, device=device)
        self.conv2 = Conv(hidden_dim, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv2(torch.relu(self.conv1(x))))[..., 0]


class BoundaryAdjust(nn.Module):
    """Second-stage offsets from 3-point boundary probes (BoundaryAdjust.py)."""

    def __init__(self, hidden_dim: int, temporal_scale: int,
                 base_stride: int = 1, device=None):
        super().__init__()
        self.temporal_scale, self.base_stride = temporal_scale, base_stride
        for side in ("start", "end"):
            setattr(self, f"{side}_conv1",
                    Conv(hidden_dim, hidden_dim, 3, padding="VALID",
                         device=device))
            setattr(self, f"{side}_conv2", Conv(hidden_dim, 1, 1,
                                                device=device))

    def forward(self, loc_box: torch.Tensor, feat: torch.Tensor):
        """loc_box [B, N, 2] (feature coords); feat [B, T, C]."""
        beta = 8.0
        tmax = self.temporal_scale // self.base_stride - 1
        loc = torch.clamp(loc_box, 0.0, self.temporal_scale - 1)
        blen = (loc[:, :, 1] - loc[:, :, 0] + 1) / beta
        c = feat.shape[-1]

        def gather(pos):
            # truncation toward zero, as astype(int32)
            idx = torch.clamp((pos / self.base_stride).to(torch.int32), 0, tmax)
            return torch.gather(feat, 1, idx.long()[..., None].expand(-1, -1, c))

        def probes(side):
            center = gather(loc[:, :, side])
            left = gather(loc[:, :, side] - blen)
            right = gather(loc[:, :, side] + blen)
            return torch.stack([left, center, right], dim=2)  # [B, N, 3, C]

        def offset_net(name, x):
            h = getattr(self, f"{name}_conv1")(x.reshape(-1, 3, c))
            o = getattr(self, f"{name}_conv2")(torch.relu(h))
            return o.reshape(x.shape[0], x.shape[1])

        return offset_net("start", probes(0)), offset_net("end", probes(1))

    @staticmethod
    def update_bd(loc, start_off, end_off):
        return torch.stack([loc[:, :, 0] + start_off, loc[:, :, 1] + end_off],
                           dim=2)


class VSGN(nn.Module):
    """Full VSGN detector (VSGN.py:17-108). `anchors` (a buffer, not a
    parameter) holds the levels' anchors, finest first. The JAX class's
    `use_xgpn=False` (plain strided convolutions in place of the xGN
    levels), which no caller sets, is not ported."""

    def __init__(self, input_feat_dim: int = 4096, hidden_dim: int = 256,
                 num_levels: int = 5, temporal_scale: int = 928,
                 anchor_scales: Tuple[float, ...] = (1.0, 10.0),
                 num_classes: int = 111,  # Ego4D MQ taxonomy + background
                 use_vss: bool = True, base_stride: int = 1, device=None):
        super().__init__()
        self.input_feat_dim, self.hidden_dim = input_feat_dim, hidden_dim
        self.num_levels, self.temporal_scale = num_levels, temporal_scale
        self.anchor_scales = tuple(anchor_scales)
        self.num_classes, self.base_stride = num_classes, base_stride
        self.xGPN = XGPN(input_feat_dim, hidden_dim, num_levels, use_vss,
                         temporal_scale, device=device)
        self.head_dec = DetectionHead(hidden_dim, len(anchor_scales),
                                      num_classes, device=device)
        self.head_actionness = ScoreHead(hidden_dim, device=device)
        self.head_startness = ScoreHead(hidden_dim, device=device)
        self.head_endness = ScoreHead(hidden_dim, device=device)
        self.bd_adjust = BoundaryAdjust(hidden_dim, temporal_scale,
                                        base_stride, device=device)
        levels = make_anchors(temporal_scale, num_levels, anchor_scales,
                              base_stride)
        self.level_sizes = [len(a) for a in levels]
        self.register_buffer("anchors", torch.from_numpy(
            np.concatenate(levels, axis=0)).to(device), persistent=False)

    def forward(self, x: torch.Tensor, num_frms: Optional[torch.Tensor] = None
                ) -> Dict:
        """x: [B, T, C_in] -> dict of per-level predictions + scores.

        Level order of cls/reg follows the reference's reversed decoder
        (coarsest first after the flip at Loss.py:47-48), i.e. predictions
        here are already aligned with the anchors."""
        feats_enc, feats_dec = self.xGPN(x, num_frms)
        cls_pred, reg_pred = self.head_dec(feats_dec)
        # decoder emits coarse->fine; reverse to match anchors (fine->coarse)
        cls_pred, reg_pred = cls_pred[::-1], reg_pred[::-1]

        frame_feat = feats_dec[-1]  # finest level, [B, T, C]
        t_in = x.shape[1]

        def score(head):
            return linear_resize(head(frame_feat)[:, None, :], t_in)[:, 0]

        b = x.shape[0]
        anchors = torch.split(self.anchors, self.level_sizes)
        locs = [box_decode(pred.reshape(b, -1, 2), anchor[None])
                for pred, anchor in zip(reg_pred, anchors)]
        loc_dec = torch.cat(locs, dim=1)  # [B, A_total, 2]
        start_off, end_off = self.bd_adjust(loc_dec, frame_feat)
        return {
            "cls_pred": cls_pred,
            "reg_pred": reg_pred,
            "loc_dec": loc_dec,
            "actionness": score(self.head_actionness),
            "startness": score(self.head_startness),
            "endness": score(self.head_endness),
            "start_offsets": start_off,
            "end_offsets": end_off,
        }


def vsgn_losses(
    outputs: Dict,
    anchors: torch.Tensor,  # [A_total, 2]
    num_anchor_scales: int,
    num_classes: int,
    temporal_scale: float,
    gt_bbox: torch.Tensor,  # [B, Gmax, 3]
    num_gt: torch.Tensor,
    gt_action: torch.Tensor,
    gt_start: torch.Tensor,
    gt_end: torch.Tensor,
    iou_thr: Tuple[float, float] = (0.5, 0.5),
    stage2_iou_thr: float = 0.6,
) -> Dict[str, torch.Tensor]:
    """Total VSGN loss (VSGN.py:78-105 + Loss.py)."""
    b = gt_bbox.shape[0]
    cls_pred = torch.cat(
        [c.reshape(b, -1, num_anchor_scales * num_classes)
         for c in outputs["cls_pred"]], dim=1).reshape(-1, num_classes)
    reg_pred = torch.cat(
        [r.reshape(b, -1, num_anchor_scales * 2) for r in outputs["reg_pred"]],
        dim=1).reshape(-1, 2)

    cls_labels, reg_targets = prepare_targets(
        gt_bbox, num_gt, anchors, temporal_scale, iou_thr[0])
    cls_labels = cls_labels.reshape(-1)
    reg_targets = reg_targets.reshape(-1, 2)
    all_anchors = anchors[None].expand(b, -1, -1).reshape(-1, 2)

    pos = (cls_labels > 0).float()
    loss_cls = balanced_ce_loss(cls_pred, cls_labels)
    pred_boxes = box_decode(reg_pred, all_anchors)
    target_boxes = box_decode(reg_targets, all_anchors)
    loss_reg = giou_loss(pred_boxes, target_boxes, pos)

    loss_action = weighted_bi_loss(outputs["actionness"], gt_action)
    loss_start = weighted_bi_loss(outputs["startness"], gt_start)
    loss_end = weighted_bi_loss(outputs["endness"], gt_end)

    # stage 2: boundary-adjusted boxes vs targets matched at higher IoU
    adjusted = BoundaryAdjust.update_bd(
        outputs["loc_dec"], outputs["start_offsets"], outputs["end_offsets"]
    ).reshape(-1, 2)
    cls2, reg2 = prepare_targets(gt_bbox, num_gt, anchors, temporal_scale,
                                 stage2_iou_thr)
    pos2 = (cls2.reshape(-1) > 0).float()
    tgt2 = box_decode(reg2.reshape(-1, 2), all_anchors)
    loss_bd = giou_loss(adjusted, tgt2, pos2)

    total = loss_cls + loss_reg + loss_action + loss_start + loss_end + loss_bd
    return {
        "loss_cls_dec": loss_cls,
        "loss_reg_dec": loss_reg,
        "loss_action": loss_action,
        "loss_start": loss_start,
        "loss_end": loss_end,
        "loss_bd_adjust": loss_bd,
        "loss_total": total,
    }
