"""Frame readers (host-side; OpenCV, and PyAV or decord where asked for):
the port's copy of `egovlpv2_tpu/data/readers.py`.

Capability-parity target: `EgoVLPv2/base/base_dataset.py:226-410`:
  * generic seek-read (read_frames_cv2:226)
  * EgoClip chunked reader: 30 fps index math, 600 s chunks, clips spanning
    two chunk files, pad-repeat-last-frame (read_frames_cv2_egoclip:252-303)
  * EPIC JPEG frame-dir reader (read_frames_cv2_epic:305)
  * Charades fps-based window reader (read_frames_cv2_charades:323)
  * PyAV and decord readers (read_frames_av:356, read_frames_decord:372-392)

`cv2`, `av` and `decord` are imported inside each call: a machine without
them imports this module and fails only when it reads a video. Frames come
back as float32 [T, H, W, C] in [0, 1], with the sampled source indices.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from egovlpv2_torch.data.sampling import (
    sample_frames,
    sample_frames_clips,
    sample_frames_start_end,
)

EGOCLIP_FPS = 30
EGOCLIP_CHUNK_SEC = 600


def _cv2():
    import cv2

    return cv2


def _stack01(frames: List[np.ndarray]) -> np.ndarray:
    return np.stack(frames).astype(np.float32) / 255.0


def _open(cv2, video_path):
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")
    return cap


def read_frames_cv2(video_path, num_frames, sample="rand", fix_start=None, rng=None):
    cv2 = _cv2()
    cap = _open(cv2, video_path)
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


def read_frames_cv2_egoclip(
    video_path_1,
    video_path_2,
    num_frames,
    sample,
    start_sec,
    end_sec,
    bound_sec,
    rng=None,
):
    """Two-chunk spanning reads at 30 fps over 600 s chunk files."""
    cv2 = _cv2()
    cap1 = _open(cv2, video_path_1)
    vlen1 = int(cap1.get(cv2.CAP_PROP_FRAME_COUNT))
    if video_path_1 == video_path_2:
        cap2, vlen2 = cap1, vlen1
    else:
        cap2 = _open(cv2, video_path_2)
        vlen2 = int(cap2.get(cv2.CAP_PROP_FRAME_COUNT))

    start_f = max(0, int(start_sec * EGOCLIP_FPS))
    end_f = max(0, int(end_sec * EGOCLIP_FPS))
    bound_f = int(bound_sec * EGOCLIP_FPS)
    idxs = sample_frames_start_end(num_frames, start_f, end_f, sample=sample, rng=rng)

    frames, ok_idxs = [], []
    for index in idxs:
        _index = index % (EGOCLIP_CHUNK_SEC * EGOCLIP_FPS)
        if index > bound_f:
            _index = min(_index, vlen2)
            cap2.set(cv2.CAP_PROP_POS_FRAMES, _index - 1)
            ret, frame = cap2.read()
        else:
            _index = min(_index, vlen1)
            cap1.set(cv2.CAP_PROP_POS_FRAMES, _index - 1)
            ret, frame = cap1.read()
        if ret:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok_idxs.append(index)
    if not frames:
        raise RuntimeError(f"no frames decoded from {video_path_1}")
    while len(frames) < num_frames:  # pad-repeat the last frame
        frames.append(frames[-1])
    cap1.release()
    if cap2 is not cap1:
        cap2.release()
    return _stack01(frames), ok_idxs


def read_frames_cv2_epic(
    video_path, start_frame, stop_frame, num_frames, sample="rand", fix_start=None,
    rng=None,
):
    """EPIC JPEG frame directories: frame_0000000123.jpg."""
    cv2 = _cv2()
    idxs = sample_frames_start_end(
        num_frames, start_frame, stop_frame, sample=sample, fix_start=fix_start, rng=rng
    )
    frames = []
    for index in idxs:
        name = "frame_" + str(index).zfill(10) + ".jpg"
        frame = cv2.imread(os.path.join(video_path, name))
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frames.append(frame)
    return _stack01(frames), idxs


def read_frames_cv2_charades(
    video_path, num_frames, sample, start_sec=None, end_sec=None, fix_start=None,
    rng=None,
):
    cv2 = _cv2()
    cap = _open(cv2, video_path)
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    if not start_sec and not end_sec:
        idxs = sample_frames(num_frames, vlen, sample=sample,
                             fix_start=fix_start, rng=rng)
    else:
        start_f = max(0, int(start_sec * fps))
        end_f = min(int(end_sec * fps), vlen)
        idxs = sample_frames_start_end(num_frames, start_f, end_f, sample=sample,
                                       fix_start=fix_start, rng=rng)
    frames, ok_idxs = [], []
    for index in idxs:
        cap.set(cv2.CAP_PROP_POS_FRAMES, index - 1)
        ret, frame = cap.read()
        if ret:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok_idxs.append(index)
    cap.release()
    return _stack01(frames), ok_idxs


def read_frames_av(video_path, num_frames, sample="rand", fix_start=None, rng=None):
    """PyAV reader for containers cv2 seeks poorly (webm): decode the whole
    stream, then sample (base_dataset.py:356-370)."""
    import av  # optional dependency

    frames: List[np.ndarray] = []
    try:
        with av.open(video_path) as reader:
            frames = [f.to_rgb().to_ndarray() for f in reader.decode(video=0)]
    except Exception as exc:
        # the reference prints and returns an empty list here
        # (base_dataset.py:366-370), which crashes downstream anyway; a
        # decode failure is the dataset's to handle (strict re-raises, lax
        # substitutes black frames), so the real error propagates instead
        # of being masked by np.stack([]).
        print(f"{type(exc).__name__}: av reader cannot open {video_path}.")
        raise
    if not frames:
        raise RuntimeError(f"av reader decoded no frames from {video_path}")
    idxs = sample_frames(num_frames, len(frames), sample=sample,
                         fix_start=fix_start, rng=rng)
    return _stack01([frames[i] for i in idxs]), idxs


def read_frames_decord(video_path, num_frames, sample="rand", fix_start=None, rng=None):
    import decord  # optional dependency

    vr = decord.VideoReader(video_path, num_threads=1)
    idxs = sample_frames(num_frames, len(vr), sample=sample, fix_start=fix_start,
                         rng=rng)
    frames = vr.get_batch(idxs).asnumpy()
    return frames.astype(np.float32) / 255.0, idxs


def read_frames_decord_start_end(video_path, start, end, num_frames):
    import decord

    vr = decord.VideoReader(video_path, num_threads=1)
    idxs = sample_frames_clips(start, end, len(vr), num_frames + 1)
    frames = vr.get_batch(idxs).asnumpy()
    return frames.astype(np.float32) / 255.0, idxs


VIDEO_READERS = {
    "av": read_frames_av,
    "cv2": read_frames_cv2,
    "cv2_egoclip": read_frames_cv2_egoclip,
    "cv2_epic": read_frames_cv2_epic,
    "cv2_charades": read_frames_cv2_charades,
    "decord": read_frames_decord,
    "decord_start_end": read_frames_decord_start_end,
}


def get_video_len(video_path) -> int:
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return 0
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return vlen
