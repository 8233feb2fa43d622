"""Downstream head datasets (host-side numpy): the port's copy of
`EgoTaskQADataset` of `egovlpv2_tpu/downstream/datasets.py`
(`EgoTaskQA/EgoTaskQA_dataset.py:19-112`): formatted qas_encode.json items
(question, answer_encode, reasoning types, interval -> video path). The
EgoMQ, EgoNLQ and QFVS datasets of that file are not copied yet
(ROADMAP.md A11).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


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
