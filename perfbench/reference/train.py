"""The plain reference of the training steps: the objectives, ITM
hard-negative mining, AdamW with its groups and warmup-cosine schedule,
and the readings a run is judged by.

A task's reference is the module `perfbench/reference/<REFERENCE>.py` that
its task file names (`pretrain.py`, `dual.py`): it gives `build(model_cfg,
precision)`, the plain model whose parameter names are the program's;
`loss(model, batch, generator, cfg)`, each step's losses as a dict holding
`loss_total` and each objective's; and `group_of(name, ndim)`, the AdamW
group of a parameter. `readings` takes all three from it and knows no
model; a model that draws dropout masks takes the generator by its
`set_generator`.

EgoVLPv2's objectives and groups are written out here from the published
recipe (EgoVLPv2 `model/loss.py`, `model/model.py:370-487`,
`set_optim_schedule.py`), importing nothing of the port: EgoNCE + MLM +
itm_weight * ITM for pre-training (one shared unfused-video pass feeds MLM
and ITM), NormSoftmax over the dual towers for the Charades-Ego fine-tune.
Mining draws a fair coin a row, one categorical draw a row over the
softmaxed similarity with the EgoNCE positives masked out, and shuffles
which half of the rows are positive; it draws from the same generator as
dropout, in the port's order and over float32 weights as the port draws
them, but from its own similarity, so a near tie can mine another negative
than the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from perfbench.reference.model import sim_matrix

HEAD_NAMES = ("mlm_score", "itm_score", "txt_proj", "vid_proj")
CROSS_MODAL_NAMES = ("cross_modal", "i2t", "t2i")
NO_DECAY_SUBSTR = ("bias", "LayerNorm", ".norm.", ".norm1.", ".norm2.")


# ---------------------------------------------------------------- objectives

def egonce_loss(sim, sim_v, sim_n, temperature, noun=True, verb=True):
    """Scene-aware InfoNCE: a pair is an extra positive iff it shares a verb
    and a noun. Returns (loss, positive mask)."""
    eye = torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)
    if noun and verb:
        mask = sim_v * sim_n + eye
    elif noun:
        mask = sim_n + eye
    elif verb:
        mask = sim_v + eye
    else:
        mask = eye
    pos = mask > 0
    i_sm = torch.softmax(sim / temperature, dim=1)
    j_sm = torch.softmax(sim.T / temperature, dim=1)
    return (-torch.log((i_sm * pos).sum(dim=1)).mean()
            - torch.log((j_sm * pos.T).sum(dim=1)).mean()), pos


def norm_softmax_loss(sim, temperature):
    i = torch.log_softmax(sim / temperature, dim=1)
    j = torch.log_softmax(sim.T / temperature, dim=1)
    return -torch.diag(i).mean() - torch.diag(j).mean()


def masked_lm_loss(logits, labels):
    """Mean cross-entropy over the positions whose label is not -100."""
    logits = logits.reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, 1, safe[:, None])[:, 0]
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1)


def cross_entropy(logits, labels):
    return -torch.gather(torch.log_softmax(logits, dim=-1), 1,
                         labels[:, None]).mean()


def mine_itm(generator, sim, pos, temperature):
    """(video index, text index, labels) of the mined ITM batch."""
    b, dev = sim.shape[0], sim.device
    half = b // 2
    labels = torch.cat([torch.ones(half, dtype=torch.long, device=dev),
                        torch.zeros(b - half, dtype=torch.long, device=dev)])
    labels = labels[torch.randperm(b, generator=generator, device=dev)]
    sim = sim.detach().float()
    zero = torch.zeros_like(sim)
    w_t2v = torch.where(pos, zero, torch.softmax(sim.T / temperature, dim=1))
    w_v2t = torch.where(pos, zero, torch.softmax(sim / temperature, dim=1))
    neg_video = torch.multinomial(w_t2v + 1e-9, 1, generator=generator)[:, 0]
    neg_text = torch.multinomial(w_v2t + 1e-9, 1, generator=generator)[:, 0]
    coin = torch.rand(b, generator=generator, device=dev) < 0.5
    own = torch.arange(b, device=dev)
    is_pos = labels == 1
    video = torch.where(is_pos, own, torch.where(coin, neg_video, own))
    text = torch.where(is_pos, own, torch.where(coin, own, neg_text))
    return video, text, labels


def pretrain_loss(model: nn.Module, batch, generator, cfg: dict):
    lc = cfg["loss"]
    ids, mask = batch["text_ids"], batch["text_mask"]
    tokens = model.video_model.patchify(batch["video"])
    t_emb = model.compute_text(ids, mask)
    v_emb = model.compute_video(tokens)
    sim = sim_matrix(t_emb, v_emb)
    verb, noun = batch["verb_vec"].to(sim.dtype), batch["noun_vec"].to(
        sim.dtype)
    loss_nce, pos = egonce_loss(sim, sim_matrix(verb, verb),
                                sim_matrix(noun, noun), lc["temperature"],
                                lc["noun"], lc["verb"])
    v_un = model.video_unfused(tokens)
    loss_mlm = masked_lm_loss(
        model.mlm_logits(v_un, batch["text_mlm_ids"], mask),
        batch["text_mlm_labels"])
    video, text, labels = mine_itm(generator, sim, pos, lc["temperature"])
    loss_itm = cross_entropy(model.itm_logits(v_un[video], ids[text],
                                              mask[text]), labels)
    total = (loss_nce + lc["mlm_weight"] * loss_mlm
             + lc["itm_weight"] * loss_itm)
    return {"loss_total": total, "loss_egonce": loss_nce,
            "loss_mlm": loss_mlm, "loss_itm": loss_itm}


def dual_loss(model: nn.Module, batch, generator, cfg: dict):
    tokens = model.video_model.patchify(batch["video"])
    sim = sim_matrix(model.compute_text(batch["text_ids"], batch["text_mask"]),
                     model.compute_video(tokens))
    return {"loss_total": norm_softmax_loss(sim, cfg["loss"]["temperature"])}


# ---------------------------------------------------------------- optimizer

def group_of(name: str, ndim: int) -> str:
    """The AdamW group of parameter `name`: {backbone, head, cross} x
    {wd, nd}, by substrings of its flax path (digits folded into the module
    name, LayerNorm scales and embeddings renamed), as the recipe labels
    them: the time-attention norm3 decays, the fusion gates are in the
    cross-modal decay group."""
    *parts, leaf = name.split(".")
    mods: List[str] = []
    for part in parts:
        if part.isdigit():
            mods[-1] = f"{mods[-1]}_{part}"
        else:
            mods.append(part)
    if leaf == "weight":
        if ndim == 1:
            leaf = "scale"
        elif mods[-1].endswith(("embeddings", "embedding")):
            leaf = "embedding"
        else:
            leaf = "kernel"
    path = "." + ".".join(mods + [leaf]) + "."
    nd = any(s in path for s in NO_DECAY_SUBSTR)
    head = any(h in path for h in HEAD_NAMES)
    cross = any(c in path for c in CROSS_MODAL_NAMES)
    grp = "head" if head and not cross else (
        "cross" if cross and not head else "backbone")
    return f"{grp}_{'nd' if nd else 'wd'}"


def lr_factor(optim: dict, count: int) -> float:
    """Linear warmup from 0, then a cosine to 0 (or a polynomial to
    end_lr), at update count `count`."""
    wf, total = optim["warmup_frac"], optim["max_steps"]
    warmup = max(int(wf * total), 1) if wf < 1 else int(wf)
    if count < warmup:
        return count / warmup
    done = min(max(count - warmup, 0), total - warmup) / (total - warmup)
    if optim["decay_power"] == "cosine":
        return 0.5 * (1.0 + math.cos(math.pi * done))
    power = 1.0 if optim["decay_power"] in ("poly1", "linear") \
        else float(optim["decay_power"])
    end = optim["end_lr"] / optim["lr"]
    return (1.0 - end) * (1.0 - done) ** power + end


class AdamW:
    """Decoupled weight decay, then the Adam step with bias correction,
    parameter by parameter; `group_of(name, ndim)` puts each parameter in
    {backbone, head, cross} x {wd, nd}."""

    def __init__(self, model, optim: dict,
                 group_of: Callable[[str, int], str]):
        mult = {"backbone": 1.0, "head": optim["lr_mult_head"],
                "cross": optim["lr_mult_cross_modal"]}
        self.o = optim
        self.params = []
        for name, p in model.named_parameters():
            g = group_of(name, p.dim())
            self.params.append((name, p, optim["lr"] * mult[g.split("_")[0]],
                                optim["weight_decay"] if g.endswith("_wd")
                                else 0.0))
        self.m = {n: torch.zeros_like(p) for n, p, _, _ in self.params}
        self.v = {n: torch.zeros_like(p) for n, p, _, _ in self.params}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns each parameter's gradient as it took it."""
        b1, b2 = self.o["betas"]
        eps = self.o["eps"]
        factor = lr_factor(self.o, self.count)
        self.count += 1
        t = self.count
        grads = {}
        for name, p, lr_peak, wd in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g
            lr = lr_peak * factor
            p.mul_(1.0 - lr * wd)
            self.m[name].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[name].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            p.addcdiv_(self.m[name], denom, value=-lr / (1.0 - b1 ** t))
        return grads


def readings(cfg: dict, reference,
             weights: Dict[str, torch.Tensor], batches,
             generator: torch.Generator, steps: int,
             precision: str = "float64", device="cpu") -> dict:
    """Run `steps` steps of the task's `reference` module from `weights` on
    `batches` (one each) and return what a program run is compared by: each
    step's losses (the total and each objective's), the first step's
    gradient and the parameters' change over the steps, leaf by leaf.
    `precision` "float64" computes in float64 (the reference), "fp8"
    computes every product in float8 (the control, `model.Precision`);
    parameters and AdamW's state are float32 in both. TF32 is off for the
    run."""
    from perfbench.reference.model import Precision

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = reference.build(cfg["model"], Precision(
            "fp8" if precision == "fp8" else "exact")).to(device)
        names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])
        if hasattr(model, "set_generator"):
            model.set_generator(generator)
        model.train()
        opt = AdamW(model, cfg["optim"], reference.group_of)
        losses, first = [], None
        for i in range(steps):
            for _, p, _, _ in opt.params:
                p.grad = None
            parts = reference.loss(model, batches[i], generator, cfg)
            parts["loss_total"].backward()
            grads = opt.step()
            losses.append({k: float(v.detach()) for k, v in parts.items()})
            if i == 0:
                first = grads
            del grads, parts
        with torch.no_grad():
            change = {n: p - weights[n] for n, p in model.named_parameters()}
        return {"names": names, "losses": losses, "grads": first,
                "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
