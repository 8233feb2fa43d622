"""End-to-end task orchestrators (port of `egovlpv2_tpu/tasks/orchestrators.py`):
so far `run_egotaskqa`, the EgoTaskQA fine-tune and evaluation. EgoMQ,
EgoNLQ and QFVS follow with their heads (ROADMAP.md A11).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from egovlpv2_torch.core.config import ModelConfig


def run_egotaskqa(
    backbone_cfg: ModelConfig,
    train_items,  # indexable of dicts with video/text_ids/text_mask/answer
    val_items,
    num_answers: int,
    reasoning_types: Sequence[str] = (),
    epochs: int = 1,
    batch_size: int = 8,
    lr: float = 2e-4,
    warmup_frac: float = 0.1,
    save_dir: Optional[str] = None,
    resume: bool = False,
    test_only: bool = False,
    backbone_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
    on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None,
) -> Dict[str, float]:
    """Fine-tune the fused backbone + QA head, report overall and
    per-reasoning-type accuracy (EgoTaskQA/main_end2end.py:84-200 recipe:
    single-LR AdamW + cosine warmup).

    `save_dir` checkpoints the run each epoch; `resume` restarts from the
    latest checkpoint (main_end2end.py:164-172: global_step -> epoch);
    `test_only` skips training and evaluates the restored checkpoint
    (main_end2end.py:174-200). `backbone_state_dict` (an `EgoVLPv2`
    state_dict, e.g. an imported pretrain checkpoint) is overlaid onto the
    backbone before training, the names the two share.

    On a CUDA device this sets TF32 off for matmuls and cuDNN: the float32
    path runs in full float32. `on_step(step, metrics, seconds)` is called
    after every training step with the host's time of the step, from its
    numpy batch to the end of its device work.
    """
    from egovlpv2_torch.data.loader import DataLoader, default_collate
    from egovlpv2_torch.downstream.taskqa import (evaluate_qa, make_qa_model,
                                                  make_qa_train_step)
    from egovlpv2_torch.train.checkpoint import (CheckpointManager,
                                                 load_train_state_,
                                                 train_state)
    from egovlpv2_torch.train.optimizer import make_adamw_warmup_cosine
    from egovlpv2_torch.weights import overlay_, training_init_

    if test_only and not save_dir:
        # without a checkpoint to restore, "evaluation" would silently score
        # randomly-initialized QA-head weights and report it as a result
        raise ValueError("test_only requires save_dir (the checkpoint "
                         "directory to evaluate)")
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = make_qa_model(backbone_cfg, num_answers, device=device)
    init = torch.Generator().manual_seed(0)
    training_init_(model.backbone, init)
    training_init_(model.qa_head, init)
    steps_per_epoch = max(len(train_items) // batch_size, 1)
    total_steps = max(epochs * steps_per_epoch, 1)
    optimizer, scheduler = make_adamw_warmup_cosine(
        model, lr, max(int(total_steps * warmup_frac), 1), total_steps)
    if backbone_state_dict is not None:
        # intersection overlay: the QA model holds only the fused-encode
        # path, while a pretrain checkpoint carries projection/MLM heads too
        overlay_(model.backbone, backbone_state_dict)
    generator = torch.Generator(device=device).manual_seed(1)

    ckpt = None
    start_epoch = 0
    step = 0
    if save_dir:
        ckpt = CheckpointManager(save_dir)
        if resume or test_only:
            restored = ckpt.restore()
            if restored is not None:
                step = load_train_state_(restored, model, optimizer,
                                         scheduler, generator)
                start_epoch = step // steps_per_epoch
            elif test_only:
                raise FileNotFoundError(
                    f"test_only: no checkpoint found under {save_dir}")

    if not test_only:
        train_step = make_qa_train_step(model, optimizer, scheduler,
                                        generator)
        loader = DataLoader(train_items, batch_size)
        for epoch in range(start_epoch, epochs):
            for batch in loader.epoch(epoch):
                t0 = time.perf_counter()
                metrics = train_step({k: v for k, v in batch.items()
                                      if k != "reasoning_types"})
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                seconds = time.perf_counter() - t0
                step += 1
                if on_step is not None:
                    on_step(step, {k: float(v) for k, v in metrics.items()},
                            seconds)
            if ckpt:
                ckpt.save(step, train_state(model, optimizer, scheduler,
                                            generator, step))
        if ckpt:
            ckpt.wait()

    val_batches = []
    for i in range(0, len(val_items) - batch_size + 1, batch_size):
        chunk = [val_items[j] for j in range(i, i + batch_size)]
        b = default_collate(chunk)
        b["reasoning_types"] = [it.get("reasoning_types", []) for it in chunk]
        val_batches.append(b)
    return evaluate_qa(model, val_batches, list(reasoning_types))
