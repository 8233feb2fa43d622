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

Over W > 1 processes (`parallel/`) every rank computes the one loss of
the global batch, as GSPMD does for the JAX step: EgoNCE on the gathered
embeddings and verb/noun vectors, ITM mined on the global similarity by a
generator that draws the same on every rank (each rank runs the fused pass
on its rows of the mined batch and the logits are gathered), MLM as the
global masked-token mean; `make_train_step` averages the gradients over
the ranks. Without a process group the gathers are the identity.

`path_remat` wraps each objective path in one
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)` region, under
the JAX package's condition (`path_remat and not model.remat`). With
`model.remat` the towers make every block a region of its own
(`models/video.py`, `models/text.py`).
The JAX package's `EGOVLP_MERGED_FUSED` branch (one 2B-wide fused stack, a
measured loss there) is left behind.

The step records its phases as host spans (`utils/logging.py::span`):
`egovlpv2.step` around each call, with `egovlpv2.step.zero_grad`, `.put`,
`.forward` (the paths of `pretrain_loss_fn` inside it as
`egovlpv2.forward.egonce`, `.video_unfused`, `.mlm`, `.itm_mining` and
`.itm`), `.backward` and `.optimizer` (with `egovlpv2.optimizer.grad_sync`
and `egovlpv2.optimizer.adamw`). A step replayed as one CUDA graph
(`GraphStep`) runs no Python inside the graph: its call records
`egovlpv2.step`, `.put` (with the copy into the graph's inputs) and
`.replay`; the call that captures the graph records `.capture` around the
phases as the capture ran them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import distributed as dist
from torch import nn

from egovlpv2_torch.core.config import TrainConfig
from egovlpv2_torch.data.loader import DeviceBatch, device_put
from egovlpv2_torch.models.dropout import checkpoint_region
from egovlpv2_torch.models.egovlp import EgoVLPv2, sim_matrix
from egovlpv2_torch.objectives.itm_mining import mine_itm_indices
from egovlpv2_torch.objectives.losses import (egonce_loss, itm_loss,
                                              masked_lm_sums,
                                              norm_softmax_loss)
from egovlpv2_torch.parallel.collectives import (all_gather, all_reduce_sum,
                                                 sync_gradients)
from egovlpv2_torch.parallel.distributed import rank
from egovlpv2_torch.utils.logging import CAPTURE, REPLAY, STEP, span


def pretrain_loss_fn(model: EgoVLPv2, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator], *, cfg: TrainConfig,
                     loss_scale: float = 1.0,
                     path_remat: Optional[bool] = None,
                     mining_generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss * loss_scale, metrics) of the global batch. `batch`
    holds this rank's rows, tensors on the model's device (the keys of
    `tasks.pretrain.synthetic_batch`); `generator` is the one given to
    `model.set_generator` (the dropout masks, replayed by the checkpoint
    regions), and draws the ITM mining too unless `mining_generator` is
    given, as it must be over W > 1 ranks. Dropout follows the model's
    `train()` / `eval()` mode."""
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

    # ---- EgoNCE (dual towers, over the global batch) ----
    # each path's span lies around its checkpoint region, so a backward
    # that rebuilds the region re-enters no span
    with span("egovlpv2.forward.egonce"):
        t_emb = all_gather(bound(model.compute_text)(ids, mask))
        v_emb = all_gather(bound(lambda tok: model.compute_video(None, tok))(
            tokens))
        sim = sim_matrix(t_emb, v_emb)
        if lcfg.type == "EgoNCE":
            verb, noun = all_gather(batch["verb_vec"]), all_gather(
                batch["noun_vec"])
            sim_v = sim_matrix(verb, verb)
            sim_n = sim_matrix(noun, noun)
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
        with span("egovlpv2.forward.video_unfused"):
            v_un = bound(lambda tok: model.video_unfused(None, tok))(tokens)

    if "MLM" in cfg.tasks:
        with span("egovlpv2.forward.mlm"):
            mlm_logits = bound(model.mlm_forward_from_video)(
                v_un, batch["text_mlm_ids"], mask)
            # the global masked-token mean: every rank's sum over every count
            total, count = masked_lm_sums(mlm_logits,
                                          batch["text_mlm_labels"])
            loss_mlm = all_reduce_sum(total) / torch.clamp(
                all_reduce_sum(count), min=1)
        loss = loss + lcfg.mlm_weight * loss_mlm
        metrics["loss_mlm"] = loss_mlm

    if "ITM" in cfg.tasks:
        with span("egovlpv2.forward.itm_mining"):
            idx = mine_itm_indices(
                generator if mining_generator is None else mining_generator,
                sim.detach(), mask_bool, temp)
        with span("egovlpv2.forward.itm"):
            # this rank's rows of the global mined batch, from every rank's
            # tokens; a mined row's gradient goes back to the rank that
            # owns it
            lo = rank() * ids.shape[0]
            rows = slice(lo, lo + ids.shape[0])
            vid, txt = idx.video_idx[rows], idx.text_idx[rows]
            ids_all, mask_all = all_gather(ids), all_gather(mask)
            itm_logits = all_gather(bound(model.itm_forward_from_video)(
                all_gather(v_un)[vid], ids_all[txt], mask_all[txt]))
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


def captures_graph(device: torch.device, cfg: TrainConfig,
                   path_regions: bool) -> bool:
    """Whether `make_train_step` replays its step as one CUDA graph: on a
    CUDA device, without a process group (the collectives stay eager), and
    with no checkpoint region in the step, neither a block's
    (`cfg.model.remat`) nor a path's (`path_regions`): a region's rebuild
    sets the generator's state on the host, which a graph cannot hold."""
    return (device.type == "cuda"
            and not (dist.is_available() and dist.is_initialized())
            and not cfg.model.remat and not path_regions)


def capturable_(optimizer: torch.optim.Optimizer,
                device: torch.device) -> None:
    """AdamW as a CUDA graph replays it, in place: `capturable`, each
    group's learning rate a 0-d float32 tensor on `device` (the scheduler
    fills it in place each step; a float would be frozen into the graph at
    its capture value) and the step counts there too. Tensors already so
    stay the same objects."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        lr = group["lr"]
        if not (torch.is_tensor(lr) and lr.device == device
                and lr.dtype == torch.float32):
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=device)
    for state in optimizer.state.values():
        count = state.get("step")
        if torch.is_tensor(count) and count.device != device:
            state["step"] = count.to(device=device, dtype=torch.float32)


def _signature(batch) -> tuple:
    """A batch's keys, shapes and dtypes as the caller hands it over
    (arrays, tensors or a `DeviceBatch`): batches alike here are alike on
    the device."""
    return tuple((k, tuple(np.shape(v)), str(
        v.dtype if hasattr(v, "dtype") else np.asarray(v).dtype))
        for k, v in sorted(batch.items(), key=lambda kv: kv[0]))


class GraphStep:
    """The training step replayed as one CUDA graph: `update` (forward,
    backward, zero fill, clip or norm, AdamW) captured once for one batch
    signature (keys, shapes, dtypes) and launched with one
    `cudaGraphLaunch` a call, the scheduler stepped after it.

    A call whose signature was also the last eager call's captures, then
    replays once; a later call of the captured signature replays; any other
    call is the `eager` step (the first, a loader's short last batch). A
    call of another signature than the captured one first drops the graph
    and frees its memory pool, so that the eager step has the device's
    memory to itself; a signature that repeats is captured again. Each call
    is one update. A replay copies the batch into the graph's inputs and
    returns fresh copies of its metrics, so a caller may hold a step's
    metrics across later calls. The dropout and mining generators are
    registered with the graph: every replay draws anew, in the eager
    step's order. The model's parameters, the optimizer's state and its
    learning rates must stay the tensors they were at the capture (load a
    state before the first call)."""

    def __init__(self, model: nn.Module, eager: Callable, update: Callable,
                 optimizer, scheduler, generators, device: torch.device):
        self.model, self.eager, self.update = model, eager, update
        self.optimizer, self.scheduler = optimizer, scheduler
        self.generators, self.device = generators, device
        self.graph = self.signature = self.last = None
        self.inputs = self.outputs = None

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        sig = _signature(batch)
        if self.graph is not None and sig != self.signature:
            self._drop()
        if self.graph is None and sig != self.last:
            self.last = sig
            # a state loaded since the build (a resumed run) brings its
            # own learning rates and flags
            capturable_(self.optimizer, self.device)
            return self.eager(batch)
        with span(STEP):
            self.model.train()
            with span("egovlpv2.step.put"):
                batch = batch_to_device(batch, self.device)
                if self.graph is not None:
                    for k, v in self.inputs.items():
                        v.copy_(batch[k])
            if self.graph is None:
                with span(CAPTURE):
                    self._capture(batch, sig)
            with span(REPLAY):
                self.graph.replay()
                self.scheduler.step()
                return {k: v.clone() for k, v in self.outputs.items()}

    def _capture(self, batch, sig) -> None:
        # no gradient before the capture: the graph's backward assigns
        # them where it would otherwise accumulate into last step's
        self.optimizer.zero_grad(set_to_none=True)
        capturable_(self.optimizer, self.device)
        self.inputs = {k: v.clone() for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # `torch.cuda.graph` synchronises and empties the allocator's cache
        # first, so the pool starts from the eager step's freed memory;
        # other threads (a loader's feeder) may keep using the device
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.outputs = self.update(self.inputs, schedule=False)
        self.graph, self.signature = graph, sig

    def _drop(self) -> None:
        """The graph and every tensor of its pool (the gradients, the
        metrics) let go, and the pool returned to the device."""
        self.optimizer.zero_grad(set_to_none=True)
        self.graph = self.signature = self.inputs = self.outputs = None
        torch.cuda.empty_cache()


def make_train_step(model: EgoVLPv2, cfg: TrainConfig,
                    optimizer: torch.optim.Optimizer, scheduler,
                    generator: Optional[torch.Generator] = None,
                    loss_scale: float = 1.0,
                    loss_fn: Optional[Callable] = None,
                    mining_generator: Optional[torch.Generator] = None):
    """Returns step(batch) -> metrics: forward, backward, the mean of the
    gradients over the ranks of a process group, the optional gradient
    clip, one AdamW update and one scheduler step, in place on `model`.
    Metrics are detached tensors on the model's device (no synchronisation
    here); `grad_norm` joins them when `cfg.log_grad_norm`. `loss_fn(model,
    batch)` returns (loss, metrics); the default is `pretrain_loss_fn` with
    `generator`, `mining_generator` and `loss_scale`. The step keeps
    `generator` and `mining_generator` as its attributes of those names.

    Where `captures_graph` holds, the step is a `GraphStep` and AdamW is
    made `capturable_` at once, so that every call, eager or replayed,
    runs the same update; its `eager(batch)` is the eager step."""
    path_regions = loss_fn is None and cfg.path_remat
    if loss_fn is None:
        loss_fn = functools.partial(pretrain_loss_fn, generator=generator,
                                    cfg=cfg, loss_scale=loss_scale,
                                    mining_generator=mining_generator)
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    model.set_generator(generator)

    def update(batch, schedule: bool = True) -> Dict[str, torch.Tensor]:
        with span("egovlpv2.step.forward"):
            loss, metrics = loss_fn(model, batch)
        # the main thread's wait on the autograd engine, which launches
        # the backward's kernels from its own thread
        with span("egovlpv2.step.backward"):
            loss.backward()
        with span("egovlpv2.step.optimizer"):
            # A parameter the loss does not reach (the fusion gates of
            # a dual model) has a zero gradient in the JAX package,
            # where every leaf has one; it gets one here, so AdamW
            # decays it alike.
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            # the clip and the norm see the global gradient
            with span("egovlpv2.optimizer.grad_sync"):
                sync_gradients(params)
            if cfg.optim.grad_clip is not None:
                norm = nn.utils.clip_grad_norm_(params, cfg.optim.grad_clip)
            elif cfg.log_grad_norm:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad) for p in params
                     if p.grad is not None]))
            if cfg.log_grad_norm:
                metrics["grad_norm"] = norm  # before the clip, as optax's
            with span("egovlpv2.optimizer.adamw"):
                optimizer.step()
            if schedule:
                scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    def eager(batch) -> Dict[str, torch.Tensor]:
        with span(STEP):
            model.train()
            with span("egovlpv2.step.zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            with span("egovlpv2.step.put"):
                batch = batch_to_device(batch, device)
            return update(batch)

    step = eager
    if captures_graph(device, cfg, path_regions):
        capturable_(optimizer, device)
        # by identity: one generator may draw both
        generators = list({id(g): g for g in (generator, mining_generator)
                           if g is not None}.values())
        step = GraphStep(model, eager, update, optimizer, scheduler,
                         generators, device)
    # the generator is part of a run's state (`train/checkpoint.py::
    # train_state`): a resumed run must draw what the first would have
    step.generator = generator
    step.mining_generator = mining_generator
    return step
