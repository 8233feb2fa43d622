"""Frame readers (host-side, OpenCV): the port's copy of the readers of
`egovlpv2_tpu/data/readers.py` that the EgoTaskQA dataset uses,
`read_frames_cv2` and `get_video_len` (reference
`EgoVLPv2/base/base_dataset.py:226-250`). The EgoClip, EPIC and Charades
readers are not copied yet (ROADMAP.md A7).

`cv2` is imported inside each call: a machine without OpenCV imports this
module and fails only when it reads a video. Frames come back as float32
[T, H, W, C] in [0, 1], with the sampled source indices.
"""

from __future__ import annotations

from typing import List

import numpy as np

from egovlpv2_torch.data.sampling import sample_frames


def _cv2():
    import cv2

    return cv2


def _stack01(frames: List[np.ndarray]) -> np.ndarray:
    return np.stack(frames).astype(np.float32) / 255.0


def read_frames_cv2(video_path, num_frames, sample="rand", fix_start=None, rng=None):
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    idxs = sample_frames(num_frames, vlen, sample=sample, fix_start=fix_start, rng=rng)
    frames, ok_idxs = [], []
    for index in idxs:
        cap.set(cv2.CAP_PROP_POS_FRAMES, index - 1)
        ret, frame = cap.read()
        if ret:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok_idxs.append(index)
    cap.release()
    return _stack01(frames), ok_idxs


def get_video_len(video_path) -> int:
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return 0
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return vlen
