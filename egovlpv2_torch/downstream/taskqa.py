"""EgoTaskQA video-QA classification head and reasoning-type accuracy (port
of `egovlpv2_tpu/downstream/taskqa.py`).

Capability-parity targets:
  * `EgoTaskQA/model/video_qa_model_linear_end2end.py:171-174,260-279` — the
    full fused stack (`EgoVLPv2.fused_encode`) -> video CLS ->
    projector_2(dropout(relu(projector_1(cls)))) logits over the answer
    vocabulary, trained with plain cross-entropy over answer_encode labels;
  * `EgoTaskQA/utils/util.py:23-60` — per-reasoning-type accuracy.

The QA model's parameters are the JAX model's tree, `{"backbone": ...,
"qa_head": {"projector_1", "projector_2"}}`: the backbone keeps only what
`fused_encode` reaches (the JAX model never creates the rest), and the head
names its two Dense layers `projector.1` / `projector.2`, which the weight
bridge (`weights.py`) maps to `projector_1` / `projector_2`. Dropout follows
the module's `train()` / `eval()` mode and draws from the generator given
to `set_generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from egovlpv2_torch.core.config import ModelConfig, TrainConfig
from egovlpv2_torch.models.dense import Dense
from egovlpv2_torch.models.dropout import Dropout
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.objectives.losses import cross_entropy_loss
from egovlpv2_torch.train.step import batch_to_device, make_train_step

# Parts of `EgoVLPv2` that `fused_encode` does not reach: the JAX QA model
# has no parameters for them, so the port's drops them too.
_UNREACHED = ("txt_proj", "vid_proj", "cross_modal_text_transform",
              "cross_modal_video_transform", "cross_modal_text_pooler",
              "cross_modal_video_pooler", "itm_score", "mlm_score")


class QAHead(nn.Module):
    """projector_1 -> ReLU -> dropout -> projector_2, float32 Dense layers
    (a bf16 video CLS is promoted, as flax's Dense does with f32 params)."""

    def __init__(self, in_dim: int, num_answers: int, drop_rate: float = 0.2,
                 device=None):
        super().__init__()
        self.projector = nn.ModuleDict({
            "1": Dense(in_dim, num_answers, device=device),
            "2": Dense(num_answers, num_answers, device=device)})
        self.dropout = Dropout(drop_rate)

    def forward(self, video_cls: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.projector["1"](video_cls))
        return self.projector["2"](self.dropout(x))


class QAModel(nn.Module):
    """Fused backbone + QA head over a closed answer vocabulary:
    (video [B, F, H, W, C], input_ids, attention_mask) -> logits [B, A]."""

    def __init__(self, backbone_cfg: ModelConfig, num_answers: int,
                 device=None):
        super().__init__()
        # the fused path's CLS token and final norm exist with a fused head
        cfg = dataclasses.replace(backbone_cfg, with_itm_head=True,
                                  with_mlm_head=False, projection="")
        self.backbone = EgoVLPv2(cfg, device=device)
        for name in _UNREACHED:
            if hasattr(self.backbone, name):
                setattr(self.backbone, name, None)
        self.backbone.video_model.norm = None  # the dual tower's final norm
        self.qa_head = QAHead(cfg.video.embed_dim, num_answers, device=device)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout mask of the model in training mode comes from
        `generator` (None: PyTorch's global generator)."""
        for module in self.modules():
            if hasattr(module, "generator"):
                module.generator = generator

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        v_cls, _ = self.backbone.fused_encode(video, input_ids, attention_mask)
        return self.qa_head(v_cls)


def make_qa_model(backbone_cfg: ModelConfig, num_answers: int,
                  device=None) -> QAModel:
    """Fused backbone + QA head; answers are a closed vocabulary."""
    return QAModel(backbone_cfg, num_answers, device=device)


def qa_loss_fn(model: QAModel, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy over the answers, and the batch's accuracy. `batch`
    holds tensors on the model's device; dropout follows the model's mode."""
    logits = model(batch["video"], batch["text_ids"], batch["text_mask"])
    loss = cross_entropy_loss(logits, batch["answer"])
    acc = (logits.argmax(-1) == batch["answer"]).float().mean()
    return loss, {"loss_total": loss, "acc": acc}


def make_qa_train_step(model: QAModel, optimizer: torch.optim.Optimizer,
                       scheduler, generator: Optional[torch.Generator] = None):
    """step(batch) -> metrics: forward in training mode, backward, one AdamW
    update and one scheduler step, in place on `model` (no gradient clip,
    as optax.adamw has none). `generator` draws the dropout masks."""
    cfg = TrainConfig(model=model.backbone.cfg)
    return make_train_step(model, cfg, optimizer, scheduler, generator,
                           loss_fn=qa_loss_fn)


@torch.no_grad()
def evaluate_qa(model: QAModel, batches: Iterable[Dict],
                reasoning_types: Sequence[str]) -> Dict[str, float]:
    """Validation pass in eval mode: accuracy overall and per reasoning type
    (EgoTaskQA/main_end2end.py:375-388 gather + metric). `batches` are
    numpy batches (video, text_ids, text_mask, answer, and optionally
    reasoning_types, a list of lists of type names)."""
    model.eval()
    device = next(model.parameters()).device
    calc = ReasoningTypeAccuracy(reasoning_types)
    correct = total = 0
    for batch in batches:
        t = batch_to_device({k: batch[k] for k in
                             ("video", "text_ids", "text_mask")}, device)
        pred = model(t["video"], t["text_ids"],
                     t["text_mask"]).argmax(-1).cpu().numpy()
        label = np.asarray(batch["answer"])
        correct += int((pred == label).sum())
        total += len(label)
        calc.update(batch.get("reasoning_types", [[] for _ in label]), pred,
                    label)
    out = {"acc": correct / max(total, 1)}
    out.update({f"acc/{k}": v for k, v in calc.accuracies().items()})
    return out


def synthetic_qa_items(backbone_cfg: ModelConfig, n: int, num_answers: int,
                       text_len: int, rng: np.random.Generator,
                       reasoning_types: Sequence[str] = ()) -> List[Dict]:
    """`n` seeded QA items as `EgoTaskQADataset` and the tokenizer give them
    to `run_egotaskqa`, for runs without the benchmark's files: a normal
    clip [F, H, W, C] float32, a question of random length padded to
    `text_len` (BOS 0, EOS 2, padding 1), an answer index and a random
    subset of `reasoning_types`."""
    v = backbone_cfg.video
    items = []
    for _ in range(n):
        length = int(rng.integers(4, text_len + 1))
        ids = rng.integers(3, backbone_cfg.text.vocab_size, text_len)
        ids[0], ids[length - 1], ids[length:] = 0, 2, 1
        items.append({
            "video": rng.standard_normal(
                (v.num_frames, v.img_size, v.img_size, v.in_chans),
                dtype=np.float32),
            "text_ids": ids,
            "text_mask": (np.arange(text_len) < length).astype(np.int64),
            "answer": np.int64(rng.integers(num_answers)),
            "reasoning_types": [t for t in reasoning_types
                                if rng.random() < 0.5]})
    return items


class ReasoningTypeAccuracy:
    """Per-reasoning-type accuracy accumulator (util.py:23-60)."""

    def __init__(self, reasoning_types: Sequence[str]):
        self.types = list(reasoning_types)
        self.reset()

    def reset(self):
        self.true = {t: 0 for t in self.types}
        self.total = {t: 0 for t in self.types}

    def update(self, reasoning_type_lst: List[List[str]], pred: np.ndarray,
               label: np.ndarray):
        correct = np.asarray(pred) == np.asarray(label)
        for i, q_types in enumerate(reasoning_type_lst):
            for t in q_types:
                if correct[i]:
                    self.true[t] += 1
                self.total[t] += 1

    def accuracies(self) -> Dict[str, float]:
        return {
            t: (self.true[t] / self.total[t] if self.total[t] else 0.0)
            for t in self.types
        }
