"""EgoMCQ 5-way multiple-choice validation (port of
`egovlpv2_tpu/tasks/egomcq.py`).

Per item, 5 candidate videos against 1 query text. VTC is the batched
cosine similarity of the dual embeddings; VTM is softmax(ITM logits)[:, 1]
of the fused stack with the text repeated 5 times; the ensemble is
VTC + VTM. Accuracy is split into inter-video (type 1) and intra-video
(type 2) questions by `metrics/retrieval.py::egomcq_accuracy`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from egovlpv2_torch.metrics.retrieval import egomcq_accuracy
from egovlpv2_torch.models.egovlp import EgoVLPv2, sim_matrix_batch
from egovlpv2_torch.train.step import batch_to_device


def make_egomcq_eval_step(model: EgoVLPv2, with_vtm: bool = True
                          ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(video5, ids, mask) -> {'vtc': [B, 5], 'vtm': [B, 5]}.

    video5: [B, 5, F, H, W, C] (float32, or uint8 for on-device
    normalisation); ids/mask: [B, L]. The model runs in `eval()` mode,
    which is put back after the call. Numpy arrays or CPU tensors: the
    step copies them to the model's device (`train/step.py::
    batch_to_device`: on a card from pinned memory on a copy stream, which
    the step's stream waits for), so its time includes the input
    transfer."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(video5, ids, mask):
        # in eval(): in train() dropout would act and draw from the
        # training run's generator; the model's mode is put back
        was_training = model.training
        model.eval()
        try:
            return scores(video5, ids, mask)
        finally:
            model.train(was_training)

    def scores(video5, ids, mask):
        t = batch_to_device({"video5": video5, "ids": ids, "mask": mask},
                            device)
        video5, ids, mask = t["video5"], t["ids"].long(), t["mask"]
        b, n_opts = video5.shape[:2]
        flat_video = video5.reshape((b * n_opts,) + tuple(video5.shape[2:]))
        t_emb = model.compute_text(ids, mask)
        v_emb = model.compute_video(flat_video).reshape(b, n_opts, -1)
        out = {"vtc": sim_matrix_batch(t_emb[:, None, :], v_emb)[:, 0, :]}
        if with_vtm:
            rep_ids = ids.repeat_interleave(n_opts, dim=0)
            rep_mask = mask.repeat_interleave(n_opts, dim=0)
            logits = model.itm_forward(flat_video, rep_ids, rep_mask)
            vtm = torch.softmax(logits.float(), dim=-1)[:, 1]
            out["vtm"] = vtm.reshape(b, n_opts)
        return out

    return step


def evaluate_egomcq(eval_step, batches: Iterable[dict]) -> Dict[str, float]:
    """batches yield dicts with video5/ids/mask/answer/type (numpy)."""
    vtc_all, vtm_all, labels, types = [], [], [], []
    for batch in batches:
        out = eval_step(batch["video5"], batch["ids"], batch["mask"])
        vtc_all.append(out["vtc"].cpu().numpy())
        if "vtm" in out:
            vtm_all.append(out["vtm"].cpu().numpy())
        labels.append(np.asarray(batch["answer"]))
        types.append(np.asarray(batch["type"]))
    vtc = np.concatenate(vtc_all)
    labels = np.concatenate(labels)
    types = np.concatenate(types)
    metrics = {}
    for k, v in egomcq_accuracy(vtc, labels, types).items():
        metrics[f"vtc/{k}"] = v
    if vtm_all:
        vtm = np.concatenate(vtm_all)
        for k, v in egomcq_accuracy(vtm, labels, types).items():
            metrics[f"vtm/{k}"] = v
        for k, v in egomcq_accuracy(vtc + vtm, labels, types).items():
            metrics[f"ensemble/{k}"] = v
    return metrics
