"""QFVS staged feature extraction: unfused tokens -> KTS -> fused shot
features (port of `egovlpv2_tpu/tasks/qfvs_extract.py`).

Capability-parity targets, as the JAX package states them:
  * `QFVS/extract_features.py:65-146` — stage 1: every 5 consecutive frames
    form one clip; the unfused video tower (fused-path CLS + the unfused
    blocks) produces per-clip tokens; the CLS-feature kernel K = F F^T
    drives cpd_auto segmentation into <= max_segments segments, each clip
    becoming a "shot";
  * `QFVS/extract_multimodal_features.py:67-150` — stage 2: concept prompts
    "There is a X" go through the unfused text tower once; each shot's
    tokens run the fused lockstep blocks -> video CLS ->
    cross_modal_video_transform -> the per-(shot, prompt) features the
    summary scorer consumes.

Everything runs in `eval()` mode under `torch.no_grad()` on the model's
device, in inner batches (`tasks.extract.InnerBatchRunner`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from egovlpv2_torch.downstream.qfvs import cpd_auto
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks.extract import (InnerBatchRunner,
                                          pad_to_inner_batches, window_frames)

FRAMES_PER_CLIP = 5


class QFVSExtractor:
    def __init__(self, model: EgoVLPv2, inner_batch: int = 16):
        if model.cfg.video.num_frames < FRAMES_PER_CLIP:
            # the reference QFVS pipeline treats 5 frames as one "clip"
            # (extract_features.py:65-146); the temporal embedding must
            # cover them (load 4-frame checkpoints with temporal inflation)
            raise ValueError(
                f"QFVS extraction needs video.num_frames >= {FRAMES_PER_CLIP} "
                f"(got {model.cfg.video.num_frames}); import the checkpoint "
                "with num_frames=5 temporal inflation")
        self.model = model.eval()
        self.inner_batch = inner_batch
        self.device = next(model.parameters()).device
        self.runner = InnerBatchRunner(self.device)

    @property
    def batch_log(self):
        """(first input's shape, ms) of every inner batch run so far."""
        return self.runner.log

    def _fuse(self, v_tokens, t_tokens, mask):
        b = v_tokens.shape[0]
        v_cls, _ = self.model.fuse_from_unfused(
            v_tokens, t_tokens.expand(b, *t_tokens.shape[1:]),
            mask.expand(b, mask.shape[1]), FRAMES_PER_CLIP)
        return self.model.cross_modal_video_transform(v_cls)

    def unfused_clip_tokens(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, C] -> per-clip unfused tokens [N_clips, S, D]
        (5 frames = 1 clip; tail padded by repeating the last frame)."""
        clips = window_frames(frames, FRAMES_PER_CLIP)
        chunks = pad_to_inner_batches([clips], self.inner_batch)
        return self.runner.run(self.model.video_unfused,
                               chunks)[:clips.shape[0]]

    def segment_shots(self, clip_tokens: np.ndarray, max_segments: int = 20,
                      vmax: float = 1.0) -> np.ndarray:
        """KTS over the CLS kernel -> segment boundaries
        (extract_features.py:65-146). Returns change points in clip units."""
        cls_feats = clip_tokens[:, 0].astype(np.float64)  # [N_clips, D]
        K = cls_feats @ cls_feats.T
        ncp = min(max_segments - 1, max(cls_feats.shape[0] - 1, 1))
        cps, _ = cpd_auto(K, ncp, vmax)
        return np.asarray(cps, int)

    @torch.no_grad()
    def concept_text_tokens(self, tokenizer, concepts: Sequence[str]):
        """'There is a X' prompts -> unfused text tokens
        (dataset_prompt.py:70-76)."""
        tok = tokenizer([f"There is a {c}" for c in concepts])
        t = self.model.text_unfused(
            torch.from_numpy(np.asarray(tok["text_ids"])).to(self.device),
            torch.from_numpy(np.asarray(tok["text_mask"])).to(self.device))
        return t.float().cpu().numpy(), tok["text_mask"]

    def fused_shot_features(self, clip_tokens: np.ndarray,
                            text_tokens: np.ndarray,
                            text_mask: np.ndarray) -> np.ndarray:
        """Per-shot fused CLS -> cross_modal_video_transform [N_clips, hs].

        clip_tokens [N_clips, S, D] unfused video tokens; text_tokens
        [1, St, D] and text_mask [1, St], one prompt's."""
        compute = getattr(torch, self.model.cfg.compute_dtype)
        t = torch.from_numpy(np.asarray(text_tokens)).to(self.device, compute)
        m = torch.from_numpy(np.asarray(text_mask)).to(self.device)
        chunks = pad_to_inner_batches([clip_tokens], self.inner_batch)
        return self.runner.run(
            lambda v: self._fuse(v.to(compute), t, m),
            chunks)[:clip_tokens.shape[0]]

    def extract_video(self, frames: np.ndarray, tokenizer,
                      concepts: Sequence[str],
                      oracle_prompt: Optional[str] = None,
                      max_segments: int = 20) -> Dict[str, np.ndarray]:
        """Full per-video pipeline: stage 1 + KTS + stage 2 for each prompt."""
        clip_tokens = self.unfused_clip_tokens(frames)
        cps = self.segment_shots(clip_tokens, max_segments)
        prompts = list(concepts) + ([oracle_prompt] if oracle_prompt else [])
        t_all, m_all = self.concept_text_tokens(tokenizer, prompts)
        feats = {}
        for pi, name in enumerate(prompts):
            feats[name] = self.fused_shot_features(
                clip_tokens, t_all[pi:pi + 1], np.asarray(m_all)[pi:pi + 1])
        return {"features": feats, "change_points": cps,
                "num_shots": clip_tokens.shape[0]}
