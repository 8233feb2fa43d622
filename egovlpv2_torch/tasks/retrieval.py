"""Dual-encoder retrieval fine-tuning and evaluation: EK-100 MIR and
Charades-Ego (port of `egovlpv2_tpu/tasks/retrieval.py`).

Capability-parity targets:
  * `EgoVLPv2/model/model_epic_charades.py:410-441` — 'Dual' task forward:
    dual towers -> sim matrix -> AdaptiveMaxMargin (EPIC, relevancy
    weighted) or NormSoftmax (Charades);
  * `EgoVLPv2/trainer/trainer_epic.py:92-306` — per-iteration scheduler plus
    epoch-milestone LR decay, val gathers all embeddings then runs official
    mAP/nDCG;
  * `EgoVLPv2/trainer/trainer_charades.py:216-274` — val encodes the 157
    class-prompt sentences once, scores videos against them, charades mAP.

The step is `train/step.py::make_train_step` with `dual_loss_fn` as its
loss: forward, backward, the optional clip, AdamW and the scheduler, in
place on the model. The eval loops encode in `eval()` mode without
gradients and gather the embeddings on the host as float32 numpy.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from egovlpv2_torch.core.config import TrainConfig
from egovlpv2_torch.metrics.retrieval import charades_map, mir_metrics
from egovlpv2_torch.models.egovlp import EgoVLPv2, sim_matrix
from egovlpv2_torch.objectives.losses import max_margin_loss, norm_softmax_loss
from egovlpv2_torch.train.optimizer import make_optimizer
from egovlpv2_torch.train.step import batch_to_device, make_train_step
from egovlpv2_torch.weights import training_init_


def dual_loss_fn(model: EgoVLPv2, batch: Dict[str, torch.Tensor], *,
                 cfg: TrainConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss, metrics). `batch` holds tensors on the model's device:
    video, text_ids, text_mask and, for AdaptiveMaxMargin, the per-row
    `relevancy` weights [B]. Dropout follows the model's `train()` /
    `eval()` mode and draws from the generator given to
    `model.set_generator`."""
    lcfg = cfg.loss
    t = model.compute_text(batch["text_ids"], batch["text_mask"])
    v = model.compute_video(batch["video"])
    sim = sim_matrix(t, v)
    if lcfg.type == "AdaptiveMaxMargin":
        loss = max_margin_loss(sim, margin=lcfg.margin,
                               weight=batch["relevancy"].float())
    elif lcfg.type == "MaxMargin":
        loss = max_margin_loss(sim, margin=lcfg.margin)
    else:  # NormSoftmax (Charades)
        loss = norm_softmax_loss(sim, lcfg.temperature)
    return loss, {"loss_total": loss}


def make_dual_train_step(model: EgoVLPv2, cfg: TrainConfig,
                         optimizer: torch.optim.Optimizer, scheduler,
                         generator: Optional[torch.Generator] = None):
    """Returns step(batch) -> metrics, in place on `model` (see
    `make_train_step`)."""
    return make_train_step(model, cfg, optimizer, scheduler, generator,
                           loss_fn=functools.partial(dual_loss_fn, cfg=cfg))


def build_dual(cfg: TrainConfig, device="cuda"):
    """Returns (model, optimizer, scheduler, train_step) on `device`, seeded
    as `tasks.pretrain.build_pretrain` seeds them (the dropout generator is
    `train_step.generator`). A dual model has no ITM
    or MLM head and no fused-path norm; its towers keep the fusion
    parameters, which the loss does not reach."""
    device = torch.device(device)
    model = EgoVLPv2(cfg.model, device=device)
    training_init_(model, torch.Generator().manual_seed(cfg.seed))
    optimizer, scheduler = make_optimizer(cfg.optim, model)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    step = make_dual_train_step(model, cfg, optimizer, scheduler, generator)
    return model, optimizer, scheduler, step


def synthetic_dual_batch(cfg: TrainConfig, batch_size: int,
                         rng: np.random.Generator, tokenizer,
                         relevancy: bool = False) -> Dict[str, np.ndarray]:
    """One synthetic fine-tune batch, the draws of the JAX CLI's: normal
    video [B, F, H, W, C], one tokenized sentence repeated, and for EPIC
    (`relevancy`) all-ones per-row caption weights [B]."""
    v = cfg.model.video
    enc = tokenizer(["someone does something"] * batch_size)
    batch = {
        "video": rng.standard_normal(
            (batch_size, v.num_frames, v.img_size, v.img_size,
             v.in_chans)).astype(np.float32),
        "text_ids": enc["text_ids"],
        "text_mask": enc["text_mask"],
    }
    if relevancy:
        batch["relevancy"] = np.ones(batch_size, np.float32)
    return batch


def milestone_lr_scale(epoch: int, milestones: Tuple[int, ...]) -> float:
    """Epoch-milestone LR decay applied on top of the base schedule
    (trainer_epic.py:85-90): x0.1 at each passed milestone."""
    scale = 1.0
    for m in milestones:
        if epoch >= m:
            scale *= 0.1
    return scale


def epoch_milestone_schedule(base: float, milestones: Tuple[int, ...],
                             steps_per_epoch: int) -> Callable[[int], float]:
    """count -> `base` times 0.1 for every milestone epoch that `count` has
    reached (optax's `piecewise_constant_schedule`). With
    `base=1.0` it is the `lr_scale` multiplier of
    `train.optimizer.make_optimizer`."""
    boundaries = [m * steps_per_epoch for m in milestones]

    def schedule(count: int) -> float:
        value = base
        for b in boundaries:
            if count >= b:
                value *= 0.1
        return value

    return schedule


def train_retrieval_epochs(
    model: EgoVLPv2,
    step_fn: Callable[[Dict], Dict[str, torch.Tensor]],
    train_batches: Callable[[int], Iterable[Dict]],
    eval_fn: Optional[Callable[[EgoVLPv2], Dict[str, float]]] = None,
    epochs: int = 1,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
):
    """Epoch loop for the dual-encoder fine-tunes (trainer_epic.py:92-196):
    the per-iteration schedule steps inside `step_fn`; per-epoch validation
    via `eval_fn(model) -> metrics`. Returns the validation history."""
    history = []
    step = 0
    for epoch in range(epochs):
        for batch in train_batches(epoch):
            metrics = step_fn(batch)
            step += 1
            if log_fn is not None:
                log_fn(step, {k: float(v) for k, v in metrics.items()})
        if eval_fn is not None:
            history.append(eval_fn(model))
    return history


def make_encoders(model: EgoVLPv2):
    """Returns (encode_text(ids, mask), encode_video(video)): the dual
    embeddings as float32 numpy, computed in `eval()` mode without
    gradients on the model's device; the model's mode is put back."""
    device = next(model.parameters()).device

    def evaluated(fn):
        @torch.inference_mode()
        def run(*args):
            was_training = model.training
            model.eval()
            try:
                return fn(*args).float().cpu().numpy()
            finally:
                model.train(was_training)

        return run

    def encode_text(ids, mask):
        t = batch_to_device({"ids": ids, "mask": mask}, device)
        return model.compute_text(t["ids"].long(), t["mask"])

    def encode_video(video):
        return model.compute_video(
            batch_to_device({"video": video}, device)["video"])

    return evaluated(encode_text), evaluated(encode_video)


def _sim_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return sim_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def pool_windows(v: np.ndarray, idx: np.ndarray, *others: np.ndarray):
    """Reduce sliding-window entries back to per-video rows.

    The test-time expansion (base_dataset.py:82-106 / datasets with
    sliding_window_stride != -1) emits several windows per video sharing the
    same `idx`; video embeddings are mean-pooled per group, while `others`
    (texts, targets — identical within a group) keep their first row.
    Returns (v_pooled, unique_idx, *others_pooled).
    """
    uniq, inverse = np.unique(idx, return_inverse=True)
    pooled = np.zeros((len(uniq), v.shape[1]), np.float64)
    np.add.at(pooled, inverse, v.astype(np.float64))
    pooled /= np.bincount(inverse)[:, None]
    out = [pooled.astype(v.dtype), uniq]
    for o in others:
        first = np.zeros((len(uniq),) + o.shape[1:], o.dtype)
        # reversed so the FIRST row of each group wins
        first[inverse[::-1]] = o[::-1]
        out.append(first)
    return tuple(out)


def align_mir_similarity(
    sim_text_video: np.ndarray,  # [N, N] rows = gathered texts, cols = videos
    idx_arr: np.ndarray,  # [N] dataset indices in gathered order
    video_ids: np.ndarray,  # EPIC_100_retrieval_test.csv column 0 order
    sentence_video_ids: np.ndarray,  # ..._test_sentence.csv column 0 order
) -> np.ndarray:
    """Reorder the gathered square similarity into the official
    video x unique-sentence layout (metric.py:292-305): undo the gather
    permutation, then select the sentence columns by their video ids."""
    idx_list = idx_arr.tolist()
    order = [idx_list.index(i) for i in range(len(video_ids))]
    sim = sim_text_video[order][:, order]
    vid_list = video_ids.tolist()
    indexes = [vid_list.index(v) for v in sentence_video_ids]
    return sim.T[:, indexes]  # video x sentence


def evaluate_mir(
    model: EgoVLPv2,
    batches: Iterable[Dict],
    relevancy: np.ndarray,
    video_ids: Optional[np.ndarray] = None,
    sentence_video_ids: Optional[np.ndarray] = None,
    on_sim=None,
) -> Dict[str, float]:
    """EK-100 MIR eval: encode everything, undo the gather order, select the
    official unique-sentence columns, run official mAP/nDCG
    (trainer_epic.py:200-306 + metric.py:283-325).

    `relevancy` is the official video x sentence matrix; `video_ids` /
    `sentence_video_ids` come from the EPIC retrieval csv files. When they
    are omitted (e.g. synthetic tests) the square text x video similarity is
    used directly against `relevancy`'s shape. `on_sim(sim, idx)` receives
    the raw text x video similarity in encounter order."""
    encode_text, encode_video = make_encoders(model)
    t_all, v_all, idx_all = [], [], []
    for batch in batches:
        t_all.append(encode_text(batch["text_ids"], batch["text_mask"]))
        v_all.append(encode_video(batch["video"]))
        idx_all.append(np.asarray(batch["idx"]))
    t = np.concatenate(t_all)
    v = np.concatenate(v_all)
    idx = np.concatenate(idx_all)
    if len(np.unique(idx)) != len(idx):
        # sliding-window expansion active: pool windows per video
        v, idx, t = pool_windows(v, idx, t)
    sim_tv = _sim_matrix_np(t, v)
    if on_sim is not None:
        on_sim(sim_tv, idx)
    if video_ids is not None and sentence_video_ids is not None:
        sim = align_mir_similarity(sim_tv, idx, video_ids, sentence_video_ids)
    else:
        order = np.argsort(idx)
        sim = sim_tv[order][:, order].T[:, : relevancy.shape[1]]
    return mir_metrics(sim, relevancy)


def evaluate_charades(
    model: EgoVLPv2,
    batches: Iterable[Dict],
    class_prompt_ids: np.ndarray,
    class_prompt_mask: np.ndarray,
) -> Dict[str, float]:
    """Charades-Ego zero-shot/FT eval: 157 class prompts scored against every
    video (trainer_charades.py:216-274)."""
    encode_text, encode_video = make_encoders(model)
    cls_emb = encode_text(class_prompt_ids, class_prompt_mask)
    v_all, targets, idx_all = [], [], []
    for batch in batches:
        v_all.append(encode_video(batch["video"]))
        targets.append(np.asarray(batch["target"]))
        if "idx" in batch:
            idx_all.append(np.asarray(batch["idx"]))
    v = np.concatenate(v_all)
    gt = np.concatenate(targets)
    if idx_all:
        idx = np.concatenate(idx_all)
        if len(np.unique(idx)) != len(idx):
            v, _, gt = pool_windows(v, idx, gt)
    submission = _sim_matrix_np(cls_emb, v).T  # [N_videos, 157]
    return charades_map(submission, gt)
