"""Downstream head datasets (host-side numpy): the port's copy of
`egovlpv2_tpu/downstream/datasets.py`.

Capability-parity targets:
  * EgoMQ — `EgoMQ/Utils/dataset.py:27-204`: load per-clip [T, 4096]
    features (.pt or .npy), pad to temporal_scale=928, fps from clip
    duration, gt boxes in normalized feature coords + BMN-style
    action/start/end IOA match scores, padded gt boxes (max 50);
  * EgoTaskQA — `EgoTaskQA/EgoTaskQA_dataset.py:19-112`: formatted
    qas_encode.json items (question, answer_encode, reasoning types,
    interval -> video path);
  * EgoNLQ — `EgoNLQ/utils/data_gen.py` (EpisodicNLQProcessor): flatten
    language queries with exact (s, e) spans, time<->index conversion via
    downstream.nlq_eval, per-query visual features from the extractor.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def load_features(path_base: str) -> np.ndarray:
    """Load extractor output: prefers .npy, falls back to torch .pt."""
    if os.path.exists(path_base + ".npy"):
        return np.load(path_base + ".npy")
    if os.path.exists(path_base + ".pt"):
        import torch

        return torch.load(path_base + ".pt", map_location="cpu").numpy()
    raise FileNotFoundError(path_base + ".{npy,pt}")


def ioa_with_anchors(a_min, a_max, box_min, box_max):
    """Intersection over anchor length (dataset.py:182-188)."""
    inter = np.maximum(np.minimum(a_max, box_max) - np.maximum(a_min, box_min), 0.0)
    return inter / (a_max - a_min)


class EgoMQFeatureDataset:
    """VSGN inputs from extracted clip features.

    Windowing/stitching beyond the reference port: the reference's dataset
    truncates every clip at `temporal_scale` (EgoMQ/Utils/dataset.py:105-109
    — `clip_start = 0`, `win_data[:, :num_frms]`), silently dropping moments
    in longer clips. With `window_stride` set, clips longer than
    temporal_scale expand into overlapping windows whose proposals map back
    to clip seconds via `offset_sec` (mq_infer adds it). With `use_vss`,
    short train clips are self-stitched (VSGN's Video Self-Stitching: an
    up-scaled copy appended after `stitch_gap`), matching the neighbor
    re-picking that vsgn.knn_indices already implements from the reference's
    GCNs.py:32 threshold math.
    """

    MAX_GT = 50

    def __init__(
        self,
        clip_anno: str,
        feature_path: str,
        subset: str = "train",
        mode: str = "train",
        temporal_scale: int = 928,
        input_feat_dim: int = 4096,
        moment_classes: Optional[str] = None,
        window_stride: Optional[int] = None,
        use_vss: bool = False,
        stitch_gap: int = 30,
        short_ratio: float = 0.4,
    ):
        with open(clip_anno) as f:
            anno = json.load(f)
        self.clips = {
            k: v for k, v in anno.items() if v.get("subset", "train") in subset
        }
        self.clip_list = sorted(self.clips.keys())
        self.feature_path = feature_path
        self.mode = mode
        self.tscale = temporal_scale
        self.dim = input_feat_dim
        if moment_classes and os.path.exists(moment_classes):
            with open(moment_classes) as f:
                self.classes = json.load(f)
        else:
            labels = sorted(
                {a["label"] for v in self.clips.values()
                 for a in v.get("annotations", [])}
            )
            self.classes = {"Background": 0}
            self.classes.update({c: i + 1 for i, c in enumerate(labels)})
            if moment_classes:
                with open(moment_classes, "w") as f:
                    json.dump(self.classes, f)

        self.use_vss = use_vss
        self.stitch_gap = stitch_gap
        self.short_ratio = short_ratio
        # expand long clips into overlapping windows (reference truncates)
        self.items: List = []
        for name in self.clip_list:
            if window_stride is None:
                self.items.append((name, 0))
                continue
            info = self.clips[name]
            feats = load_features(
                os.path.join(self.feature_path, info.get("clip_id", name)))
            total = feats.shape[0]
            duration = info["parent_end_sec"] - info["parent_start_sec"]
            fps = total / duration
            last = max(total - self.tscale, 0)
            offsets = list(range(0, last + 1, window_stride)) or [0]
            if offsets[-1] != last:
                offsets.append(last)  # always cover the clip tail
            for off in offsets:
                if mode == "train" and info.get("annotations"):
                    # keep only windows overlapping >=1 moment
                    lo, hi = off, min(off + self.tscale, total)
                    keep = any(
                        ann["end_time"] * fps > lo and ann["start_time"] * fps < hi
                        for ann in info["annotations"]
                    )
                    if not keep:
                        continue
                self.items.append((name, off))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx) -> Dict[str, Any]:
        name, offset = self.items[idx]
        info = self.clips[name]
        feats = load_features(
            os.path.join(self.feature_path, info.get("clip_id", name))
        )  # [T, D]
        duration = info["parent_end_sec"] - info["parent_start_sec"]
        fps = feats.shape[0] / duration
        win = feats[offset : offset + self.tscale]
        t = win.shape[0]
        video = np.zeros((self.tscale, self.dim), np.float32)
        video[:t] = win
        out = {"video": video, "num_frms": np.int32(t), "clip_name": name,
               "fps": np.float32(fps), "duration": np.float32(duration),
               "offset_sec": np.float32(offset / fps)}
        if self.mode != "train":
            return out

        gt = []
        for ann in info["annotations"]:
            s_f = ann["start_time"] * fps - offset
            e_f = ann["end_time"] * fps - offset
            if e_f <= 0 or s_f >= t:  # moment outside this window
                continue
            s = max(min(t - 1, s_f), 0) / self.tscale
            e = max(min(t - 1, e_f), 0) / self.tscale
            gt.append([s, e, float(self.classes[ann["label"]])])
        if not gt:
            # reference parity fallback (dataset.py:127-133 clamps everything
            # into [0, num_frms-1], degenerate boxes included)
            for ann in info["annotations"]:
                s = max(min(t - 1, ann["start_time"] * fps - offset), 0)
                e = max(min(t - 1, ann["end_time"] * fps - offset), 0)
                gt.append([s / self.tscale, e / self.tscale,
                           float(self.classes[ann["label"]])])

        if self.use_vss and gt and t <= self.short_ratio * self.tscale:
            # VSS self-stitch: x2 up-scaled copy after stitch_gap; the model
            # side bounds graph neighbors at (num_frms + gap) (vsgn.py).
            start2 = t + self.stitch_gap
            copy = np.repeat(win, 2, axis=0)
            m = min(copy.shape[0], self.tscale - start2)
            if m > 0:
                video[start2 : start2 + m] = copy[:m]
                for s, e, c in list(gt):
                    s2 = start2 + 2 * s * self.tscale
                    e2 = start2 + 2 * e * self.tscale
                    if e2 < start2 + m:  # copy moment fully inside canvas
                        gt.append([s2 / self.tscale, e2 / self.tscale, c])
                out["video"] = video
        gt = np.asarray(gt, np.float32)

        gap = 1.0 / self.tscale
        anchors_min = np.arange(self.tscale) * gap
        anchors_max = anchors_min + gap
        action = np.zeros(self.tscale, np.float32)
        for s, e, c in gt:
            lo = max(int(round(s * self.tscale)), 0)
            hi = min(int(round(e * self.tscale)), self.tscale - 1)
            action[lo : hi + 1] = c
        small = 3 * gap
        starts = np.stack([gt[:, 0] - small / 2, gt[:, 0] + small / 2], 1)
        ends = np.stack([gt[:, 1] - small / 2, gt[:, 1] + small / 2], 1)
        score_start = np.max(
            ioa_with_anchors(anchors_min[:, None], anchors_max[:, None],
                             starts[None, :, 0], starts[None, :, 1]), axis=1,
        ).astype(np.float32)
        score_end = np.max(
            ioa_with_anchors(anchors_min[:, None], anchors_max[:, None],
                             ends[None, :, 0], ends[None, :, 1]), axis=1,
        ).astype(np.float32)

        gt_pad = np.zeros((self.MAX_GT, 3), np.float32)
        n = min(len(gt), self.MAX_GT)
        gt_pad[:n] = gt[:n]
        out.update(
            gt_bbox=gt_pad,
            num_gt=np.int32(n),
            gt_action=(action > 0).astype(np.float32),
            gt_start=score_start,
            gt_end=score_end,
        )
        return out


class EgoTaskQADataset:
    """QA items over video intervals (EgoTaskQA_dataset.py:19-112)."""

    def __init__(self, qa_json: str, video_dir: str, num_frames: int = 16,
                 input_res: int = 224, split: str = "train", seed: int = 0):
        with open(qa_json) as f:
            self.items = json.load(f)
        self.video_dir = video_dir
        self.num_frames = num_frames
        self.input_res = input_res
        self.split = split
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx) -> Dict[str, Any]:
        from egovlpv2_torch.data import readers, transforms

        item = self.items[idx % len(self.items)]
        path = os.path.join(self.video_dir, str(item["interval"]) + ".mp4")
        clip, _ = readers.read_frames_cv2(
            path, self.num_frames,
            sample="rand" if self.split == "train" else "uniform", rng=self.rng,
        )
        if self.split == "train":
            clip = transforms.train_transform(clip, self.rng, size=self.input_res)
        else:
            clip = transforms.eval_transform(clip, size=self.input_res)
        out = np.zeros((self.num_frames, self.input_res, self.input_res, 3),
                       np.float32)
        out[: clip.shape[0]] = clip
        return {
            "video": out,
            "text": str(item["question"]),
            "answer": np.int32(item["answer_encode"]),
            "reasoning_types": item.get("type", "").split("$") if item.get("type")
            else [],
        }


class NLQFeatureDataset:
    """VSLNet inputs: per-query fused window features + raw text tokens.

    Built from extractor dumps: <clip_uid>_<annotation_uid>_<query_idx>.npy
    video features and matching *_query.npy text tokens (EgoNLQ/main.py
    caching layout, re-expressed with .npy)."""

    def __init__(self, meta: List[Dict], feature_dir: str, max_pos_len: int = 256):
        self.meta = meta  # dicts: clip_uid, annotation_uid, query_idx,
        #                   s_ind, e_ind, duration, num_windows, query text
        self.feature_dir = feature_dir
        self.max_pos_len = max_pos_len

    def __len__(self):
        return len(self.meta)

    def key(self, m) -> str:
        return f"{m['clip_uid']}_{m['annotation_uid']}_{m['query_idx']}"

    def __getitem__(self, idx) -> Dict[str, Any]:
        m = self.meta[idx]
        feats = load_features(os.path.join(self.feature_dir, self.key(m)))
        tokens = load_features(os.path.join(self.feature_dir,
                                            self.key(m) + "_query"))
        t = min(feats.shape[0], self.max_pos_len)
        video = np.zeros((self.max_pos_len, feats.shape[1]), np.float32)
        video[:t] = feats[:t]
        v_mask = np.zeros(self.max_pos_len, np.int32)
        v_mask[:t] = 1
        return {
            "video_features": video,
            "v_mask": v_mask,
            "query_features": tokens.astype(np.float32),
            "s_ind": np.int32(min(m["s_ind"], t - 1)),
            "e_ind": np.int32(min(m["e_ind"], t - 1)),
            "meta": m,
        }


def nlq_highlight_labels(s_ind: np.ndarray, e_ind: np.ndarray, length: int,
                         extend: float = 0.1) -> np.ndarray:
    """Highlight supervision: 1 inside the (slightly extended) gt span
    (EgoNLQ/utils/data_loader.py train collate semantics)."""
    b = s_ind.shape[0]
    out = np.zeros((b, length), np.float32)
    for i in range(b):
        s, e = int(s_ind[i]), int(e_ind[i])
        ext = int(round((e - s + 1) * extend))
        lo = max(s - ext, 0)
        hi = min(e + ext, length - 1)
        out[i, lo : hi + 1] = 1.0
    return out
