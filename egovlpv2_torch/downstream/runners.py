"""Training steps of the downstream heads (port of
`egovlpv2_tpu/downstream/runners.py`).

Capability-parity targets:
  * VSGN — `EgoMQ/Train.py:24-89`: Adam(weight_decay=1e-4) + StepLR,
    6-term loss, keep best by validation loss;
  * VSLNet — `EgoNLQ/model/VSLNet.py:26-56` + `main.py:218-330`: AdamW with
    bias/LN no-decay groups, linear warmup schedule, highlight + span loss;
  * QFVS — `QFVS/runner_train.py:95-175`: BCE over concept1/concept2/oracle
    scores, manual cosine LR.

Each optimizer is optax's of the JAX runner, step for step:
  * VSGN: `chain(add_decayed_weights(wd), adam(exponential_decay(staircase)))`
    adds wd * p to the gradient before Adam, which is
    `torch.optim.Adam(weight_decay=wd)`; the rate is
    lr * gamma^floor(count / (step_size * steps_per_epoch));
  * VSLNet: two `adamw` groups, decay 0.01 and 0, labelled over the flax
    paths (`weights.flax_path`) as `_no_decay_mask` labels them: only a
    `bias` leaf or a path with `norm` in a name skips decay, so
    `start_layer_norm` does and the scales of `ln_<i>`, `ln1` and `ln2` do
    not; a warmup-linear rate, 0 at the first update;
  * QFVS: one `adamw` group at `cosine_decay_schedule(lr, total)`.
`torch.optim.AdamW` decays decoupled, as optax's `adamw`. Each schedule is
a `LambdaLR` whose factor at count c is optax's schedule at c over lr, so
the scheduler steps once after each update.

A step takes a numpy batch, puts it on the model's device and returns the
loss parts as tensors there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from egovlpv2_torch.downstream import qfvs as qfvs_mod
from egovlpv2_torch.downstream import vsgn as vsgn_mod
from egovlpv2_torch.downstream import vslnet as vslnet_mod
from egovlpv2_torch.train.step import batch_to_device
from egovlpv2_torch.weights import flax_init_, flax_path

Batch = Dict[str, torch.Tensor]


def _decays(name: str, ndim: int) -> bool:
    """`_no_decay_mask` of the JAX runners, over the parameter's flax path."""
    path = flax_path(name, ndim)
    return not (path[-1] == "bias" or any("norm" in p.lower() for p in path))


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _updating(model, optimizer, scheduler, loss_fn: Callable):
    """step(batch) -> loss parts: the model in training mode, backward, one
    update and one scheduler step."""

    def step(batch) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, parts = loss_fn(batch)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {k: v.detach() for k, v in parts.items()}

    return step


# ---------------- VSGN / EgoMQ ----------------


def make_vsgn_train_step(model: vsgn_mod.VSGN, lr: float = 1e-4,
                         step_size: int = 10, gamma: float = 0.5,
                         steps_per_epoch: int = 1000,
                         weight_decay: float = 1e-4):
    """Returns (optimizer, scheduler, step, loss_fn): `loss_fn(batch) ->
    (total, parts)` runs the model as it is (the validation calls it under
    `torch.no_grad()`), `step(batch)` one update."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 weight_decay=weight_decay)
    period = step_size * steps_per_epoch
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: gamma ** (count // period))
    device = _model_device(model)

    def loss_fn(batch) -> Tuple[torch.Tensor, Batch]:
        b = batch_to_device(batch, device)
        out = model(b["video"], b["num_frms"])
        losses = vsgn_mod.vsgn_losses(
            out, model.anchors, len(model.anchor_scales), model.num_classes,
            float(model.temporal_scale), b["gt_bbox"], b["num_gt"],
            b["gt_action"], b["gt_start"], b["gt_end"])
        return losses["loss_total"], losses

    return (optimizer, scheduler,
            _updating(model, optimizer, scheduler, loss_fn), loss_fn)


# ---------------- VSLNet / EgoNLQ ----------------


def warmup_linear_factor(num_train_steps: int, warmup_proportion: float
                         ) -> Callable[[int], float]:
    """count -> the JAX runner's VSLNet rate over lr: count / warm during
    the warmup (warm at least 1), then linear to 0 at num_train_steps."""
    warm = max(int(num_train_steps * warmup_proportion), 1)

    def factor(count: int) -> float:
        if count < warm:
            return count / warm
        return max((num_train_steps - count) / max(num_train_steps - warm, 1),
                   0.0)

    return factor


def make_vslnet_train_step(model: vslnet_mod.VSLNet, lr: float = 1e-3,
                           num_train_steps: int = 10000,
                           warmup_proportion: float = 0.0,
                           highlight_lambda: float = 5.0):
    """Returns (optimizer, scheduler, step, predict). `predict(video_features,
    v_mask, query_features, q_mask, k=5)` -> top-k (start, end) indices, in
    `eval()` without gradients."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (decay if _decays(name, p.dim()) else no_decay).append(p)
    optimizer = torch.optim.AdamW(
        [{"params": decay, "weight_decay": 0.01},
         {"params": no_decay, "weight_decay": 0.0}], lr=lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, warmup_linear_factor(num_train_steps, warmup_proportion))
    device = _model_device(model)

    def loss_fn(batch) -> Tuple[torch.Tensor, Batch]:
        b = batch_to_device(batch, device)
        h, s_logits, e_logits = model(b["video_features"], b["v_mask"],
                                      b["query_features"], b["q_mask"])
        hl = vslnet_mod.HighLightLayer.loss(h, b["h_labels"], b["v_mask"])
        span = vslnet_mod.span_loss(s_logits, e_logits, b["s_ind"],
                                    b["e_ind"])
        loss = span + highlight_lambda * hl
        return loss, {"loss_total": loss, "loss_span": span,
                      "loss_highlight": hl}

    @torch.no_grad()
    def predict(video_features, v_mask, query_features, q_mask, k: int = 5):
        model.eval()
        _, s_logits, e_logits = model(video_features, v_mask, query_features,
                                      q_mask)
        return vslnet_mod.extract_top_spans(s_logits, e_logits, k=k)

    return (optimizer, scheduler,
            _updating(model, optimizer, scheduler, loss_fn), predict)


# ---------------- QFVS ----------------


def make_qfvs_train_step(model: qfvs_mod.SummaryScorer, lr: float = 1e-4,
                         weight_decay: float = 1e-5, total_steps: int = 1000,
                         generator: Optional[torch.Generator] = None):
    """Returns (optimizer, scheduler, step, score). The loss runs the scorer
    once for each of concept1, concept2 and oracle; the JAX runner gives
    the three calls one dropout key, so the three take the same masks here
    too: `generator` (the model's) is set back before each. `score(feats,
    seg_len)` -> logits, in `eval()` without gradients."""
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda count: 0.5 * (1 + math.cos(math.pi * min(count, total_steps)
                                          / total_steps)))
    device = _model_device(model)

    def loss_fn(batch) -> Tuple[torch.Tensor, Batch]:
        b = batch_to_device(batch, device)
        start = None if generator is None else generator.get_state()
        loss = torch.zeros((), device=device)
        for key in ("concept1", "concept2", "oracle"):
            if start is not None:
                generator.set_state(start)
            logits = model(b[f"feat_{key}"], b["seg_len"])
            loss = loss + qfvs_mod.qfvs_bce_loss(logits, b[f"{key}_GT"],
                                                 b["mask"])
        return loss, {"loss_total": loss}

    @torch.no_grad()
    def score(feats, seg_len):
        model.eval()
        return model(feats, seg_len)

    return (optimizer, scheduler,
            _updating(model, optimizer, scheduler, loss_fn), score)


def init_head_state(model: torch.nn.Module, seed: int = 0
                    ) -> torch.Generator:
    """Generic init for a downstream head: the parameters from flax's
    default initialisers drawn with seed `seed` (`weights.flax_init_`), and
    the dropout generator on the model's device, seeded `seed + 1` and set
    on the model (as the JAX runner's state carries PRNGKey(seed + 1))."""
    flax_init_(model, torch.Generator().manual_seed(seed))
    generator = torch.Generator(device=_model_device(model))
    generator.manual_seed(seed + 1)
    if hasattr(model, "set_generator"):
        model.set_generator(generator)
    return generator
