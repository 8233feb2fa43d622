"""Dataset adapters (metadata-driven, host-side): the port's copy of
`egovlpv2_tpu/data/datasets.py`. `pandas` is imported inside the
constructors that read csv files.

Capability-parity targets:
  * EgoClip / EgoMCQ — `EgoVLPv2/data_loader/EgoClip_EgoMCQ_dataset.py`
    (tab-separated egoclip.csv, scene-aware negatives within
    video_uid + narration_time//neg_param segments, 582/118-dim noun/verb
    multi-hot vectors, 600 s chunked video paths; val = egomcq.json 5-way MCQ)
  * EK-100 MIR — `data_loader/EpicKitchens_MIR_dataset.py` (relevancy-driven
    caption sampling at train, 0-255 normalization regime, frame-dir reader)
  * Charades-Ego — `data_loader/CharadesEgo_dataset.py` (train narration
    windows; val 157-dim multi-hot action targets)

Each adapter returns plain numpy dicts; batching/tokenization happens in the
loader (`egovlpv2_torch/data/loader.py`). Black-frame lax fallback mirrors
`base_dataset.py:108-121`. `device_norm` emits uint8 video (the geometric
transform only, quantized) for the model to normalize on the device.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from egovlpv2_torch.data import readers, sampling, transforms

NOUN_DIM = 582
VERB_DIM = 118
CHUNK_SEC = 600


class EgoClipDataset:
    """EgoClip pre-training clips with scene-aware negative sampling."""

    def __init__(
        self,
        meta_path: str,
        data_dir: str,
        num_frames: int = 4,
        input_res: int = 224,
        neg_param: Optional[int] = 60,
        loading: str = "strict",
        seed: int = 0,
        device_norm: bool = False,
    ):
        import pandas as pd

        self.meta = pd.read_csv(meta_path, sep="\t", on_bad_lines="skip")
        self.data_dir = data_dir
        self.num_frames = num_frames
        self.input_res = input_res
        self.neg_param = neg_param
        self.loading = loading
        # device_norm: emit uint8 video (geometric transform only); the
        # model normalizes on device (VideoEncoderConfig.uint8_norm) — 4x
        # fewer host->device bytes per batch.
        self.device_norm = device_norm
        self.rng = np.random.default_rng(seed)
        if neg_param:
            self.meta = self.meta.assign(
                segment_id=self.meta["video_uid"]
                + "_"
                + (self.meta["narration_time"] // neg_param).astype(int).astype(str)
            )
            self._segments = self.meta.groupby("segment_id").indices

    def __len__(self):
        return len(self.meta)

    def _video_path(self, sample):
        start = max(float(sample["clip_start"]), 0)
        end = max(float(sample["clip_end"]), 0)
        c0, c1 = int(start // CHUNK_SEC), int(end // CHUNK_SEC)
        fp = [
            os.path.join(self.data_dir, sample["video_uid"], f"{c}.mp4")
            for c in (c0, c1)
        ]
        return fp, [start, end], (c0 + 1) * CHUNK_SEC

    def _frames(self, fp, sec, bound):
        try:
            clip, _ = readers.read_frames_cv2_egoclip(
                fp[0], fp[1], self.num_frames, "rand", sec[0], sec[1], bound,
                rng=self.rng,
            )
        except Exception:
            if self.loading == "strict":
                raise
            clip = np.zeros((1, self.input_res, self.input_res, 3), np.float32)
        if self.device_norm:
            clip = transforms.train_transform_uint8(
                clip, self.rng, size=self.input_res)
            out = np.zeros(
                (self.num_frames, self.input_res, self.input_res, 3), np.uint8)
        else:
            clip = transforms.train_transform(clip, self.rng, size=self.input_res)
            out = np.zeros(
                (self.num_frames, self.input_res, self.input_res, 3), np.float32)
        out[: clip.shape[0]] = clip
        return out

    def _caption(self, sample):
        noun = np.zeros(NOUN_DIM, np.float32)
        verb = np.zeros(VERB_DIM, np.float32)
        for i in ast.literal_eval(str(sample["tag_noun"])):  # a list literal
            noun[i] = 1
        for i in ast.literal_eval(str(sample["tag_verb"])):
            verb[i] = 1
        return str(sample["clip_text"]), noun, verb

    def __getitem__(self, item) -> Dict[str, Any]:
        sample = self.meta.iloc[item % len(self.meta)]
        fp, sec, bound = self._video_path(sample)
        text, noun, verb = self._caption(sample)
        out = {
            "video": self._frames(fp, sec, bound),
            "text": text,
            "noun_vec": noun,
            "verb_vec": verb,
        }
        if self.neg_param:
            idxs = self._segments[sample["segment_id"]]
            neg = self.meta.iloc[idxs[self.rng.integers(0, len(idxs))]]
            fp_n, sec_n, bound_n = self._video_path(neg)
            text_n, noun_n, verb_n = self._caption(neg)
            out.update(
                video_neg=self._frames(fp_n, sec_n, bound_n),
                text_neg=text_n,
                noun_vec_neg=noun_n,
                verb_vec_neg=verb_n,
            )
        return out


class EgoMCQDataset:
    """EgoMCQ validation: 5 candidate clips per text query."""

    def __init__(self, meta_path: str, data_dir: str, num_frames: int = 16,
                 input_res: int = 224, loading: str = "strict",
                 device_norm: bool = False):
        with open(meta_path) as f:
            self.meta = json.load(f)
        self.keys = sorted(self.meta.keys(), key=lambda s: int(s))
        self.data_dir = data_dir
        self.num_frames = num_frames
        self.input_res = input_res
        self.loading = loading
        # 5 candidate clips per item make MCQ the heaviest transfer of the
        # eval paths; uint8 + device norm quarters it
        self.device_norm = device_norm

    def __len__(self):
        return len(self.keys)

    def _clip(self, sample):
        start = max(float(sample["clip_start"]), 0)
        end = max(float(sample["clip_end"]), 0)
        c0, c1 = int(start // CHUNK_SEC), int(end // CHUNK_SEC)
        fp = [os.path.join(self.data_dir, sample["video_uid"], f"{c}.mp4")
              for c in (c0, c1)]
        try:
            clip, _ = readers.read_frames_cv2_egoclip(
                fp[0], fp[1], self.num_frames, "uniform", start, end,
                (c0 + 1) * CHUNK_SEC,
            )
        except Exception:
            if self.loading == "strict":
                raise
            clip = np.zeros((1, self.input_res, self.input_res, 3), np.float32)
        if self.device_norm:
            clip = transforms.eval_transform(clip, size=self.input_res,
                                             normalize=False)
            clip = np.round(np.clip(clip, 0.0, 1.0) * 255.0).astype(np.uint8)
            out = np.zeros(
                (self.num_frames, self.input_res, self.input_res, 3), np.uint8)
        else:
            clip = transforms.eval_transform(clip, size=self.input_res)
            out = np.zeros(
                (self.num_frames, self.input_res, self.input_res, 3),
                np.float32)
        out[: clip.shape[0]] = clip
        return out

    def __getitem__(self, item) -> Dict[str, Any]:
        q = self.meta[self.keys[item % len(self.keys)]]
        options = q["choices"]
        videos = np.stack([self._clip(options[k]) for k in sorted(options.keys(),
                                                                  key=int)])
        return {
            "video5": videos,  # [5, F, H, W, C]
            "text": str(q["query"]["clip_text"]),
            "answer": int(q["answer"]),
            "type": int(q["types"]),  # 1 inter-video / 2 intra-video
        }


class EpicKitchensMIRDataset:
    """EK-100 multi-instance retrieval (train: relevancy-sampled captions)."""

    def __init__(self, meta_dir: str, data_dir: str, split: str = "train",
                 num_frames: int = 16, input_res: int = 224, seed: int = 0,
                 sliding_window_stride: int = -1, device_norm: bool = False):
        import pandas as pd

        self.split = split
        self.data_dir = data_dir
        self.num_frames = num_frames
        self.input_res = input_res
        self.device_norm = device_norm  # train split ships uint8 (epic regime)
        self.rng = np.random.default_rng(seed)
        tag = "train" if split == "train" else "test"
        self.meta = pd.read_csv(
            os.path.join(meta_dir, f"EPIC_100_retrieval_{tag}.csv")
        )
        # test-time sliding-window expansion (_fix_temporal_samples,
        # base_dataset.py:82-106): each video row -> one entry per window
        # offset; eval reduces per-video by pooling over `idx` groups.
        self.windows = None
        if sliding_window_stride != -1 and split != "train":
            self.windows = []
            for row in range(len(self.meta)):
                s = self.meta.iloc[row]
                vlen = int(s["stop_frame"]) - int(s["start_frame"])
                for fs in sampling.sliding_window_fix_starts(
                        vlen, num_frames, sliding_window_stride):
                    self.windows.append((row, fs))
        rel_path = os.path.join(
            meta_dir, "relevancy",
            f"caption_relevancy_EPIC_100_retrieval_{tag}.pkl",
        )
        self.relevancy = None
        if split == "train" and os.path.exists(rel_path):
            import pickle

            with open(rel_path, "rb") as f:
                self.relevancy = pickle.load(f)
            self.sentences = pd.read_csv(
                os.path.join(meta_dir, "EPIC_100_retrieval_train_sentence.csv")
            )

    def __len__(self):
        return len(self.windows) if self.windows is not None else len(self.meta)

    def __getitem__(self, item) -> Dict[str, Any]:
        fix_start = None
        if self.windows is not None:
            row, fix_start = self.windows[item % len(self.windows)]
            item = row
        sample = self.meta.iloc[item % len(self.meta)]
        pid, vid = sample["participant_id"], sample["video_id"]
        frame_dir = os.path.join(self.data_dir, pid, "rgb_frames", vid)
        start, stop = int(sample["start_frame"]), int(sample["stop_frame"])
        clip, _ = readers.read_frames_cv2_epic(
            frame_dir, start, stop, self.num_frames,
            sample="rand" if self.split == "train" else "uniform",
            fix_start=fix_start, rng=self.rng,
        )
        # EPIC uses the 0-255 normalization regime
        clip255 = clip * 255.0
        if self.split == "train":
            if self.device_norm:
                # geometric only; quantize 0-255 to uint8 — the model
                # applies the EPIC regime on device (uint8_norm="epic")
                clip255 = np.round(np.clip(transforms.train_transform(
                    clip255, self.rng, size=self.input_res,
                    normalize=False), 0.0, 255.0)).astype(np.uint8)
            else:
                clip255 = transforms.train_transform(
                    clip255, self.rng, size=self.input_res,
                    mean=transforms.EPIC_MEAN, std=transforms.EPIC_STD,
                )
        else:
            clip255 = transforms.eval_transform(
                clip255, size=self.input_res,
                mean=transforms.EPIC_MEAN, std=transforms.EPIC_STD,
            )
        text = str(sample["narration"])
        relevancy = 1.0
        if self.relevancy is not None and item < self.relevancy.shape[0]:
            # sample one of the captions with relevancy > 0.1
            rel_row = self.relevancy[item]
            pos = np.where(rel_row > 0.1)[0]
            if len(pos):
                j = int(pos[self.rng.integers(0, len(pos))])
                text = str(self.sentences.iloc[j]["narration"])
                relevancy = float(rel_row[j])
        return {"video": clip255, "text": text, "relevancy": relevancy,
                "idx": int(item)}


class CharadesEgoDataset:
    """Charades-Ego: train narration clips / val 157-way multi-hot targets."""

    NUM_CLASSES = 157

    def __init__(self, meta_dir: str, data_dir: str, split: str = "train",
                 num_frames: int = 32, input_res: int = 224, seed: int = 0,
                 sliding_window_stride: int = -1, device_norm: bool = False):
        import pandas as pd

        tag = {"train": "metadata_train", "val": "metadata_val",
               "test": "metadata_test"}[split]
        self.meta = pd.read_csv(os.path.join(meta_dir, f"{tag}.csv"))
        self.split = split
        self.data_dir = data_dir
        self.num_frames = num_frames
        self.input_res = input_res
        self.device_norm = device_norm  # train split ships uint8 (imagenet)
        self.rng = np.random.default_rng(seed)
        # test-time sliding-window expansion (base_dataset.py:82-106)
        self.windows = None
        if sliding_window_stride != -1 and split != "train":
            self.windows = []
            for row in range(len(self.meta)):
                path = os.path.join(
                    self.data_dir, str(self.meta.iloc[row]["id"]) + ".mp4")
                vlen = readers.get_video_len(path)
                for fs in sampling.sliding_window_fix_starts(
                        vlen, num_frames, sliding_window_stride):
                    self.windows.append((row, fs))

    def __len__(self):
        return len(self.windows) if self.windows is not None else len(self.meta)

    def __getitem__(self, item) -> Dict[str, Any]:
        fix_start = None
        if self.windows is not None:
            row, fix_start = self.windows[item % len(self.windows)]
            item = row
        sample = self.meta.iloc[item % len(self.meta)]
        path = os.path.join(self.data_dir, str(sample["id"]) + ".mp4")
        start = sample.get("t_start", None)
        end = sample.get("t_end", None)
        clip, _ = readers.read_frames_cv2_charades(
            path, self.num_frames,
            "rand" if self.split == "train" else "uniform",
            start_sec=start, end_sec=end, fix_start=fix_start, rng=self.rng,
        )
        if self.split == "train":
            if self.device_norm:
                clip = transforms.train_transform_uint8(
                    clip, self.rng, size=self.input_res)
            else:
                clip = transforms.train_transform(
                    clip, self.rng, size=self.input_res)
            return {"video": clip, "text": str(sample["narration"])}
        clip = transforms.eval_transform(clip, size=self.input_res)
        target = np.zeros(self.NUM_CLASSES, np.float32)
        actions = str(sample.get("actions", ""))
        for act in actions.split(";"):
            if act.strip():
                target[int(act.strip().split(" ")[0][1:])] = 1
        return {"video": clip, "target": target, "idx": int(item)}


class SyntheticVideoTextDataset:
    """Random clips + token ids for tests/benchmarks without real video."""

    def __init__(self, cfg, length: int = 64, seed: int = 0):
        from egovlpv2_torch.tasks.pretrain import synthetic_batch

        self._make = lambda i: {
            k: v[0]
            for k, v in synthetic_batch(cfg, 1, np.random.default_rng(seed + i)).items()
        }
        self._len = length

    def __len__(self):
        return self._len

    def __getitem__(self, item):
        return self._make(item % self._len)
