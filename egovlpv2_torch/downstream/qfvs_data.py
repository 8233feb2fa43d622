"""QFVS (UT Egocentric) dataset adapter (a copy of
`egovlpv2_tpu/downstream/qfvs_data.py`).

Capability-parity target: `QFVS/dataset_prompt.py:16-90` (UCTDataset):
concept-pair oracle summaries per video, dense per-shot concept tags,
concept/query prompts ("There is a X [and a Y]"), segment-length masks, and
the leave-one-video-out protocol, plus `semantic_evaluation.py:30-35` Tags.mat
loading (via scipy).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONCEPT_TRANSFER = {
    "Cupglass": "Glass",
    "Musicalinstrument": "Instrument",
    "Petsanimal": "Animal",
}


def load_videos_tag(mat_path: str) -> List[np.ndarray]:
    """Tags.mat -> per-video [n_shots, n_concepts] binary matrices
    (semantic_evaluation.py:16-35)."""
    import scipy.io

    mat = scipy.io.loadmat(mat_path)
    tags = mat["Tags"]
    videos = []
    for vi in range(tags.shape[0] if tags.ndim > 1 else len(tags)):
        entry = tags[vi][0] if tags.ndim > 1 else tags[vi]
        videos.append(np.asarray(entry, dtype=np.uint8))
    return videos


class QFVSDataset:
    """Concept-pair oracle items over precomputed per-shot features.

    features_by_video: video_id -> dict with
      feat_concept1/feat_concept2/feat_oracle [max_seg, max_shot, D]
      (from tasks.qfvs_extract) and seg_len [max_seg].
    """

    def __init__(
        self,
        oracle_dir: str,  # Oracle_Summaries root with P0<v>/ subdirs
        tags_dir: str,  # Dense_per_shot_tags root
        train_videos: Sequence[int],
        features_by_video: Dict[str, Dict[str, np.ndarray]],
        max_segment_num: int = 20,
        max_frame_num: int = 200,
    ):
        self.oracle_dir = oracle_dir
        self.tags_dir = tags_dir
        self.features = features_by_video
        self.max_seg = max_segment_num
        self.max_shot = max_frame_num
        self.items: List[Tuple[str, str, str]] = []  # (concept1, concept2, vid)
        for vid in train_videos:
            d = os.path.join(oracle_dir, f"P0{vid}")
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if fname.endswith("_oracle.txt"):
                    c1, c2 = fname[: -len("_oracle.txt")].split("_")[:2]
                    self.items.append((c1, c2, str(vid)))

    def __len__(self):
        return len(self.items)

    def concept_tags(self, video_id: str, concept: str) -> np.ndarray:
        """Dense per-shot 0/1 vector for one concept (dataset_prompt.py:41-48)."""
        gt = np.zeros(self.max_seg * self.max_shot, np.float32)
        path = os.path.join(self.tags_dir, f"P0{video_id}", f"P0{video_id}.txt")
        with open(path) as f:
            for i, line in enumerate(f):
                if concept in line.strip().split(","):
                    gt[i] = 1
        return gt

    def oracle_summary(self, video_id: str, c1: str, c2: str) -> np.ndarray:
        out = np.zeros(self.max_seg * self.max_shot, np.float32)
        path = os.path.join(self.oracle_dir, f"P0{video_id}",
                            f"{c1}_{c2}_oracle.txt")
        with open(path) as f:
            for line in f:
                out[int(line.strip()) - 1] = 1  # 1-indexed shots
        return out

    @staticmethod
    def prompts(c1: str, c2: str) -> Tuple[str, str, str]:
        t1 = CONCEPT_TRANSFER.get(c1, c1)
        t2 = CONCEPT_TRANSFER.get(c2, c2)
        return (f"There is a {t1}", f"There is a {t2}",
                f"There is a {t1} and a {t2}")

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        c1, c2, vid = self.items[index % len(self.items)]
        feats = self.features[vid]
        seg_len = np.asarray(feats["seg_len"], np.int32)
        shot_num = int(seg_len.sum())
        mask_flat = np.zeros(self.max_seg * self.max_shot, np.float32)
        mask_flat[:shot_num] = 1
        p1, p2, pq = self.prompts(c1, c2)
        return {
            "video_id": vid,
            "seg_len": seg_len,
            "feat_concept1": feats["feat_concept1"].astype(np.float32),
            "feat_concept2": feats["feat_concept2"].astype(np.float32),
            "feat_oracle": feats["feat_oracle"].astype(np.float32),
            "concept1_GT": self.concept_tags(vid, c1)
            .reshape(self.max_seg, self.max_shot),
            "concept2_GT": self.concept_tags(vid, c2)
            .reshape(self.max_seg, self.max_shot),
            "oracle_GT": self.oracle_summary(vid, c1, c2)
            .reshape(self.max_seg, self.max_shot),
            "mask": (np.arange(self.max_shot)[None, :] <
                     seg_len[:, None]).astype(np.float32),
            "mask_GT": mask_flat,
            "prompts": (p1, p2, pq),
        }


def pack_shot_features(
    shot_feats: np.ndarray,  # [n_shots, D] from QFVSExtractor
    seg_boundaries: Sequence[int],  # change points (shot indices)
    max_segment_num: int = 20,
    max_frame_num: int = 200,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack flat shot features into the [max_seg, max_shot, D] layout the
    scorer consumes + per-segment lengths."""
    n, d = shot_feats.shape
    bounds = [0] + [int(b) for b in seg_boundaries if 0 < int(b) < n] + [n]
    out = np.zeros((max_segment_num, max_frame_num, d), np.float32)
    seg_len = np.zeros(max_segment_num, np.int32)
    for si in range(min(len(bounds) - 1, max_segment_num)):
        lo, hi = bounds[si], bounds[si + 1]
        take = min(hi - lo, max_frame_num)
        out[si, :take] = shot_feats[lo : lo + take]
        seg_len[si] = take
    return out, seg_len
