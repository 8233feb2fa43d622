"""The pre-training step: EgoNCE + MLM + itm_weight * ITM (port of
`egovlpv2_tpu/train/step.py`; reference `EgoVLPv2/model/model.py:370-487`
and `trainer/trainer_egoclip.py:91-200`).

  * patchify runs once a step and its tokens feed the EgoNCE tower and the
    fused stacks (the patch projection is per sample, so this equals the
    reference's three passes);
  * MLM and ITM share one unfused-video pass; ITM gathers the mined
    examples' token states and token ids instead of pixels;
  * parameters and optimizer state are float32; Dense inputs and weights
    are cast to the compute dtype by the modules (no autocast); softmax
    and the losses are float32.

`path_remat` wraps each objective path in one
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)` region, under
the JAX package's condition (`path_remat and not model.remat`). With
`model.remat` the towers make every block a region of its own
(`models/video.py`, `models/text.py`).
The JAX package's `EGOVLP_MERGED_FUSED` branch (one 2B-wide fused stack, a
measured loss there) is left behind.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from egovlpv2_torch.core.config import TrainConfig
from egovlpv2_torch.data.loader import DeviceBatch, device_put
from egovlpv2_torch.models.dropout import checkpoint_region
from egovlpv2_torch.models.egovlp import EgoVLPv2, sim_matrix
from egovlpv2_torch.objectives.itm_mining import mine_itm_indices
from egovlpv2_torch.objectives.losses import (egonce_loss, itm_loss,
                                              masked_lm_loss,
                                              norm_softmax_loss)


def pretrain_loss_fn(model: EgoVLPv2, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator], *, cfg: TrainConfig,
                     loss_scale: float = 1.0,
                     path_remat: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss * loss_scale, metrics). `batch` holds tensors on the
    model's device (the keys of `tasks.pretrain.synthetic_batch`);
    `generator` draws the ITM mining (the dropout masks come from the one
    given to `model.set_generator`, as a rule the same). Dropout follows
    the model's `train()` / `eval()` mode."""
    lcfg = cfg.loss
    if path_remat is None:
        path_remat = cfg.path_remat
    # one region a path only where the blocks are not regions themselves
    path_remat = path_remat and not cfg.model.remat

    def bound(method: Callable) -> Callable:
        return checkpoint_region(method, generator) if path_remat else method

    ids, mask = batch["text_ids"], batch["text_mask"]
    # patchify once, reused by all three paths (kept, not rematerialised)
    tokens = model.patchify(batch["video"])
    metrics = {}

    # ---- EgoNCE (dual towers over the whole batch) ----
    t_emb = bound(model.compute_text)(ids, mask)
    v_emb = bound(lambda tok: model.compute_video(None, tok))(tokens)
    sim = sim_matrix(t_emb, v_emb)
    if lcfg.type == "EgoNCE":
        sim_v = sim_matrix(batch["verb_vec"], batch["verb_vec"])
        sim_n = sim_matrix(batch["noun_vec"], batch["noun_vec"])
        loss_nce, mask_bool, temp = egonce_loss(
            sim, sim_v, sim_n, lcfg.temperature, lcfg.noun, lcfg.verb)
    else:
        loss_nce = norm_softmax_loss(sim, lcfg.temperature)
        mask_bool = torch.eye(sim.shape[0], dtype=torch.bool,
                              device=sim.device)
        temp = lcfg.temperature
    loss = loss_nce
    metrics["loss_egonce"] = loss_nce

    # ---- fused paths: one shared unfused-video pass ----
    if "MLM" in cfg.tasks or "ITM" in cfg.tasks:
        v_un = bound(lambda tok: model.video_unfused(None, tok))(tokens)

    if "MLM" in cfg.tasks:
        mlm_logits = bound(model.mlm_forward_from_video)(
            v_un, batch["text_mlm_ids"], mask)
        loss_mlm = masked_lm_loss(mlm_logits, batch["text_mlm_labels"])
        loss = loss + lcfg.mlm_weight * loss_mlm
        metrics["loss_mlm"] = loss_mlm

    if "ITM" in cfg.tasks:
        idx = mine_itm_indices(generator, sim.detach(), mask_bool, temp)
        itm_logits = bound(model.itm_forward_from_video)(
            v_un[idx.video_idx], ids[idx.text_idx], mask[idx.text_idx])
        loss_itm = itm_loss(itm_logits, idx.labels)
        loss = loss + lcfg.itm_weight * loss_itm
        metrics["loss_itm"] = loss_itm

    metrics["loss_total"] = loss
    return loss * loss_scale, metrics


def batch_to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on `device`, ready for the
    calling thread's current stream: token ids and labels as int64, as
    torch's embedding and gather take them. A `DeviceBatch` (from
    `data/loader.py::device_prefetch`) is taken as it is; any other batch
    goes through the device's one `DevicePut` (on a card, pinned memory and
    the put's copy stream)."""
    if not isinstance(batch, DeviceBatch):
        batch = device_put(device)(batch)
    return batch.wait()


def make_train_step(model: EgoVLPv2, cfg: TrainConfig,
                    optimizer: torch.optim.Optimizer, scheduler,
                    generator: Optional[torch.Generator] = None,
                    loss_scale: float = 1.0,
                    loss_fn: Optional[Callable] = None):
    """Returns step(batch) -> metrics: forward, backward, the optional
    gradient clip, one AdamW update and one scheduler step, in place on
    `model`. Metrics are detached tensors on the model's device (no
    synchronisation here); `grad_norm` joins them when
    `cfg.log_grad_norm`. `loss_fn(model, batch)` returns (loss, metrics);
    the default is `pretrain_loss_fn` with `generator` and `loss_scale`.
    The step keeps `generator` as its attribute `generator`."""
    if loss_fn is None:
        loss_fn = functools.partial(pretrain_loss_fn, generator=generator,
                                    cfg=cfg, loss_scale=loss_scale)
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    model.set_generator(generator)

    def step(batch) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch_to_device(batch, device))
        loss.backward()
        # A parameter the loss does not reach (the fusion gates of a dual
        # model) has a zero gradient in the JAX package, where every leaf
        # has one; it gets one here, so AdamW decays it alike.
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if cfg.optim.grad_clip is not None:
            norm = nn.utils.clip_grad_norm_(params, cfg.optim.grad_clip)
        elif cfg.log_grad_norm:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in params
                 if p.grad is not None]))
        if cfg.log_grad_norm:
            metrics["grad_norm"] = norm  # before the clip, as optax's
        optimizer.step()
        scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    # the generator is part of a run's state (`train/checkpoint.py::
    # train_state`): a resumed run must draw what the first would have
    step.generator = generator
    return step
