"""Dense clip feature extraction for the EgoMQ / EgoNLQ / QFVS heads (port
of `egovlpv2_tpu/tasks/extract.py`).

Capability-parity targets, as the JAX package states them:
  * `EgoVLPv2/test_mq.py:25-86` — chunk a clip into `num_frames`-frame
    windows, run them through the video tower + vid_proj (4096-d) in inner
    batches of 64, save one [N_windows, 4096] array per clip_uid;
  * `EgoNLQ/main.py:58-136` — fused per-(window, query) features: the full
    fused stack conditioned on the query text -> 768-d video CLS per window,
    plus raw (unprojected) dual text tokens for VSLNet's query encoder.

Everything runs in `eval()` mode under `torch.no_grad()` on the model's
device. Windows go through in inner batches of a fixed size (the last one
padded by repeating its last window); on a CUDA device the next inner
batch's host-to-device copy (pinned memory, a side stream) overlaps this
one's compute, and a result is fetched one inner batch late, the depth-1
pipeline of the JAX package's `_batched`. Features come back as float32
numpy arrays whatever the compute dtype. Outputs are .npy, and .pt beside
them for the reference's head-tuning code.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from egovlpv2_torch.core.config import NORM_STATS
from egovlpv2_torch.models.egovlp import EgoVLPv2


def window_frames(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """[T, H, W, C] -> [N_windows, num_frames, H, W, C]; pad-repeat the last
    frame to fill the final window (test_mq.py:60-66 semantics)."""
    t = frames.shape[0]
    n_win = -(-t // num_frames)
    pad = n_win * num_frames - t
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    return frames.reshape(n_win, num_frames, *frames.shape[1:])


def pad_to_inner_batches(arrays: Sequence[np.ndarray], inner_batch: int
                         ) -> List[Tuple[np.ndarray, ...]]:
    """Arrays that share their first axis -> inner batches of exactly
    `inner_batch` rows each, the tail filled by repeating the last row."""
    n = arrays[0].shape[0]
    n_pad = -(-n // inner_batch) * inner_batch - n
    if n_pad:
        arrays = [np.concatenate([a, np.repeat(a[-1:], n_pad, 0)])
                  for a in arrays]
    return [tuple(a[i:i + inner_batch] for a in arrays)
            for i in range(0, n + n_pad, inner_batch)]


class InnerBatchRunner:
    """Runs `fn(*tensors) -> tensor` over inner batches of host arrays on
    `device`, without gradients. On CUDA: the arrays of inner batch i + 1
    are pinned and copied on a side stream while inner batch i computes,
    and the result of inner batch i - 1 is read from its pinned buffer once
    inner batch i has been launched.

    `log` gets one (shape of the first array, milliseconds) entry an inner
    batch: the host's time from the previous result's arrival (or the
    call's start) to this one's, so the entries of a call add up to it."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.log: List[Tuple[tuple, float]] = []

    def _stage(self, arrays):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if not self.cuda:
            return [t.to(self.device) for t in tensors], None
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            staged = [t.pin_memory().to(self.device, non_blocking=True)
                      for t in tensors]
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        for t in staged:  # allocated on the side stream, read on the main one
            t.record_stream(main)
        return staged, ready

    def _collect(self, pending, clock: list) -> np.ndarray:
        host, done, shape = pending
        if done is not None:
            done.synchronize()
        now = time.perf_counter()
        self.log.append((shape, (now - clock[0]) * 1e3))
        clock[0] = now
        return host.numpy()

    @torch.no_grad()
    def run(self, fn: Callable, chunks: Sequence[Tuple[np.ndarray, ...]]
            ) -> np.ndarray:
        outs, pending = [], None
        clock = [time.perf_counter()]
        staged = self._stage(chunks[0])
        for i, chunk in enumerate(chunks):
            tensors, ready = staged
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            res = fn(*tensors).float()
            if self.cuda:
                host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
                host.copy_(res, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = res, None
            staged = self._stage(chunks[i + 1]) if i + 1 < len(chunks) else None
            if not self.cuda:  # nothing runs behind the host: no lag
                outs.append(self._collect((host, done, tuple(chunk[0].shape)),
                                          clock))
                continue
            if pending is not None:
                outs.append(self._collect(pending, clock))
            pending = (host, done, tuple(chunk[0].shape))
        if pending is not None:
            outs.append(self._collect(pending, clock))
        return np.concatenate(outs)


class FeatureExtractor:
    """Batched window extraction from one model, in `eval()` mode.

    `device_norm` ("imagenet" | "epic" | (mean, std, input_scale) | None)
    moves the normalize tail onto the device: callers ship compact uint8
    windows (4x fewer host-to-device bytes) and (x * input_scale - mean) /
    std is applied there before the encoder. With None a float window goes
    in as it is, and a uint8 one takes the model's own `video.uint8_norm`
    regime."""

    def __init__(self, model: EgoVLPv2, inner_batch: int = 64,
                 device_norm=None):
        self.model = model.eval()
        self.inner_batch = inner_batch
        self.device = next(model.parameters()).device
        self.runner = InnerBatchRunner(self.device)
        if isinstance(device_norm, str):
            device_norm = NORM_STATS[device_norm]
        self._norm_stats = None
        if device_norm is not None:
            mean, std, scale = device_norm
            self._norm_stats = (
                torch.tensor(mean, dtype=torch.float32, device=self.device),
                torch.tensor(std, dtype=torch.float32, device=self.device),
                float(scale))

    @property
    def batch_log(self) -> List[Tuple[tuple, float]]:
        """(window shape, ms) of every inner batch run so far."""
        return self.runner.log

    def _norm(self, windows: torch.Tensor) -> torch.Tensor:
        if self._norm_stats is None:
            return windows
        mean, std, scale = self._norm_stats
        return (windows.float() * scale - mean) / std

    def _video_features(self, windows):
        return self.model.compute_video(self._norm(windows))

    def _fused_features(self, windows, ids, mask):
        v_cls, _ = self.model.fused_encode(self._norm(windows), ids, mask)
        return v_cls

    def clip_features(self, frames: np.ndarray, num_frames: int) -> np.ndarray:
        """MQ-style: [T, H, W, C] -> [N_windows, projection_dim]."""
        windows = window_frames(frames, num_frames)
        chunks = pad_to_inner_batches([windows], self.inner_batch)
        return self.runner.run(self._video_features, chunks)[:windows.shape[0]]

    def fused_window_features(self, frames: np.ndarray, num_frames: int,
                              ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """NLQ-style: fused (video, query) CLS per window -> [N_windows, Dv].

        ids/mask: [L] single query (tiled over windows) or [N_windows, L]."""
        windows = window_frames(frames, num_frames)
        nw = windows.shape[0]
        if ids.ndim == 1:
            ids = np.repeat(ids[None], nw, 0)
            mask = np.repeat(mask[None], nw, 0)
        chunks = pad_to_inner_batches([windows, ids, mask], self.inner_batch)
        return self.runner.run(self._fused_features, chunks)[:nw]

    @torch.no_grad()
    def text_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Raw (unprojected) dual text tokens for VSLNet (EgoNLQ/main.py:124)."""
        tokens = self.model.compute_text_tokens(
            torch.from_numpy(np.asarray(ids)).to(self.device),
            torch.from_numpy(np.asarray(mask)).to(self.device), project=False)
        return tokens.float().cpu().numpy()


def save_features(path: str, feats: np.ndarray, pt_compatible: bool = True):
    """Write <clip_uid>.npy (+ .pt, test_mq.py:86)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".pt"):
        base = path[:-3]
    elif path.endswith(".npy"):
        base = path[:-4]
    else:
        base = path
    np.save(base + ".npy", feats)
    if pt_compatible:
        torch.save(torch.from_numpy(np.array(feats, copy=True)), base + ".pt")


def extract_nlq_features(extractor: FeatureExtractor, tokenizer, records,
                         frames_fn, num_frames: int, out_dir: str):
    """NLQ stage-1: per-(window, query) fused features + raw query tokens.

    The reference extracts these inline (`EgoNLQ/main.py:58-136`: video
    windows x query text through the full fused model -> one video CLS per
    window, plus unfused dual text tokens at :124) and caches them per
    (clip, annotation, query). Here each clip is read ONCE via
    `frames_fn(clip_uid) -> [T, H, W, C]` and every query against it reuses
    the frames; outputs land as `<clip>_<ann>_<q>.npy` + `..._query.npy`,
    the layout the NLQ feature dataset consumes.

    Returns {clip_uid: num_windows}.
    """
    os.makedirs(out_dir, exist_ok=True)
    by_clip = {}
    for rec in records:
        by_clip.setdefault(rec["clip_uid"], []).append(rec)

    num_windows = {}
    for clip_uid, recs in by_clip.items():
        frames = frames_fn(clip_uid)
        num_windows[clip_uid] = -(-frames.shape[0] // num_frames)
        for rec in recs:
            enc = tokenizer([rec["query"]])
            ids, mask = enc["text_ids"][0], enc["text_mask"][0]
            feats = extractor.fused_window_features(frames, num_frames, ids,
                                                    mask)
            tokens = extractor.text_tokens(ids[None], mask[None])[0]
            key = f"{rec['clip_uid']}_{rec['annotation_uid']}_{rec['query_idx']}"
            save_features(os.path.join(out_dir, key), feats)
            save_features(os.path.join(out_dir, key + "_query"), tokens)
    return num_windows
