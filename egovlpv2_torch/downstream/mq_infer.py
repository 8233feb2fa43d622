"""EgoMQ inference: VSGN outputs -> per-class NMS'd proposals in seconds
(port of `egovlpv2_tpu/downstream/mq_infer.py`).

Capability-parity target: `EgoMQ/Infer.py:29-160` (infer_v_asis + nms):
stage-2 score = start/end boundary scores at the (ceil+floor)/2 positions of
the adjusted locations, multiplied into the per-class softmax score; per-class
1-D NMS; coordinates divided by the clip fps into seconds. `nms_1d` and
`proposals_from_outputs` are numpy copies and run on the host;
`make_vsgn_predict` runs the model.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from egovlpv2_torch.downstream import vsgn as vsgn_mod


def nms_1d(dets: np.ndarray, thresh: float = 0.4) -> List[int]:
    """Pure numpy 1-D NMS over [start, end, score, ...] rows (Infer.py:137+)."""
    if len(dets) == 0:
        return []
    x1, x2, scores = dets[:, 0], dets[:, 1], dets[:, 2]
    lengths = x2 - x1
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1)
        iou = inter / np.maximum(lengths[i] + lengths[order[1:]] - inter, 1e-12)
        order = order[1:][iou <= thresh]
    return keep


def make_vsgn_predict(model: vsgn_mod.VSGN):
    """Inference fn (video [B, T, C], num_frms [B], tensors on the model's
    device) -> (class probs per anchor [B, A, classes], adjusted locations
    [B, A, 2], startness, endness [B, T]), in `eval()` without gradients."""

    @torch.no_grad()
    def predict(video: torch.Tensor, num_frms: torch.Tensor):
        model.eval()
        out = model(video, num_frms)
        b = video.shape[0]
        nc = model.num_classes
        cls = torch.cat([c.reshape(b, -1, len(model.anchor_scales) * nc)
                         for c in out["cls_pred"]], dim=1).reshape(b, -1, nc)
        probs = torch.softmax(cls.float(), dim=-1)
        adjusted = vsgn_mod.BoundaryAdjust.update_bd(
            out["loc_dec"], out["start_offsets"], out["end_offsets"])
        return probs, adjusted, out["startness"], out["endness"]

    return predict


def proposals_from_outputs(
    probs: np.ndarray,  # [A, num_classes]
    locations: np.ndarray,  # [A, 2] adjusted, feature coords
    startness: np.ndarray,  # [T]
    endness: np.ndarray,  # [T]
    num_frms: int,
    fps: float,
    clip_id: str,
    temporal_scale: int,
    nms_thr: float = 0.4,
    score_thresh: float = 5e-9,
    offset_sec: float = 0.0,
) -> List[Dict]:
    """Per-class selection + stage-2 boundary rescoring + NMS (Infer.py:88-134)."""
    loc = locations.copy()
    loc[:, 0] = np.clip(loc[:, 0], 0, temporal_scale - 1)
    loc[:, 1] = np.clip(loc[:, 1], 0, temporal_scale - 1)
    t = startness.shape[0]
    s_idx_hi = np.minimum(np.ceil(loc[:, 0]).astype(int), t - 1)
    s_idx_lo = np.minimum(np.floor(loc[:, 0]).astype(int), t - 1)
    e_idx_hi = np.minimum(np.ceil(loc[:, 1]).astype(int), t - 1)
    e_idx_lo = np.minimum(np.floor(loc[:, 1]).astype(int), t - 1)
    start_score = (startness[s_idx_hi] + startness[s_idx_lo]) / 2
    end_score = (endness[e_idx_hi] + endness[e_idx_lo]) / 2
    stage2 = start_score * end_score
    loc[:, 0] = np.clip(loc[:, 0], 0, num_frms - 1)
    loc[:, 1] = np.clip(loc[:, 1], 0, num_frms - 1)

    results = []
    for cls in range(1, probs.shape[1]):  # 0 = background
        sel = probs[:, cls] > score_thresh
        if not np.any(sel):
            continue
        scores = (probs[:, cls] * stage2)[sel]
        locs = loc[sel]
        dets = np.concatenate([locs, scores[:, None]], axis=1)
        keep = nms_1d(dets, nms_thr)
        for i in keep:
            results.append({
                "video_id": clip_id,
                # offset_sec maps windowed-clip proposals back to clip time
                "t_start": float(dets[i, 0] / fps) + offset_sec,
                "t_end": float(dets[i, 1] / fps) + offset_sec,
                "score": float(dets[i, 2]),
                "label": int(cls),
            })
    return results
