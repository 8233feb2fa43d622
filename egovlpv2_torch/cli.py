"""Command line of the port (counterpart of `egovlpv2_tpu/cli.py`).

Subcommands:
  pretrain — EgoClip pre-training steps (EgoNCE + MLM + ITM) on synthetic
             batches (--synthetic). Prints one JSON line a logged step
             with the loss parts and the step's milliseconds.

    python -m egovlpv2_torch.cli pretrain --synthetic --device cuda \
        --config configs/pretrain_egoclip.json --steps_per_epoch 8 \
        --set global_batch_size=16 model.remat=false path_remat=false

  egomcq   — EgoMCQ zero-shot validation on synthetic batches. The flags
             are those of the JAX CLI's `egomcq`, without the JAX
             multi-host ones, plus --device.

    python -m egovlpv2_torch.cli egomcq --config configs/eval_egomcq.json \
        --device cuda --val_batches 2

  ft-charades, ft-epic — the dual-encoder fine-tunes (Charades-Ego with
             NormSoftmax, EK-100 MIR with AdaptiveMaxMargin and per-row
             relevancy weights) on synthetic batches (--synthetic): small
             projection at 256, no ITM/MLM heads, 30 text tokens. Prints
             one JSON line a logged step with the loss and the step's
             milliseconds.

    python -m egovlpv2_torch.cli ft-charades --synthetic --device cuda \
        --config configs/ft_charades.json --steps_per_epoch 5 \
        --set global_batch_size=8 model.remat=false

  extract  — EgoMQ-style dense window features: one [N_windows,
             projection_dim] .npy/.pt a clip, from uint8 frames normalised
             on the device, in inner batches of --inner_batch windows.
             --synthetic <n_frames> takes seeded uint8 frames in place of
             --videos (one clip, `synthetic`). Prints the shape and the
             milliseconds of every inner batch.

    python -m egovlpv2_torch.cli extract --config configs/extract_mq.json \
        --device cuda --synthetic 2048 --out feats/ [--ckpt published.pth]

  taskqa   — EgoTaskQA: the fused backbone + QA head fine-tuned on QA json
             files over interval videos (`--videos` dir of <interval>.mp4),
             then overall and per-reasoning-type accuracy, printed (and
             written to --metrics_out) as one JSON line; one JSON line a
             training step with its loss and milliseconds. `--save_dir`
             checkpoints every epoch, `--resume` continues from the latest,
             `--test_only` evaluates it. The float32 path runs with TF32 off.

    python -m egovlpv2_torch.cli taskqa --device cuda --qa_train train.json \
        --qa_val val.json --videos videos/ --answer_set answer_set.txt \
        --reasoning_types all_reasoning_types.txt --save_dir qa_ckpt

`--ckpt <file.pth>` (egomcq, extract, pretrain, the fine-tunes, taskqa) imports a
checkpoint under the reference's names (`train/checkpoint_import.py`), the
temporal embedding inflated to the config's frame count.

Not ported yet, and refused with a NotImplementedError that names the
ROADMAP item (every flag of the JAX CLI's parsers parses, but the
multi-host ones, which wait for ROADMAP.md A9): real data for pretrain,
egomcq, extract and the fine-tunes (`--meta`, `--data`, `--val_meta`,
`--val_data`, `--videos` of extract, `--device_norm`, `--num_workers`,
`--neg_param`, `--classes`, `--val_batch_size`, `--sliding_window_stride`,
pretrain or a fine-tune without --synthetic), which needs the rest of the
readers and loaders of `egovlpv2_tpu/data/` (A7); checkpoints of pretrain
and the fine-tunes (`--ckpt <directory>`, `--save_dir`, `--resume`,
`--ckpt_every`: A8); the training loop's validation and monitor
(`--val_synthetic`, `--val_batches` of pretrain, `--val_vtc_only`,
`--monitor`, `--early_stop`, `--init_val`: A10a); the retrieval visualizer
(`--visualize`: A10).

Without a checkpoint every parameter is drawn from a torch.Generator seeded
with the config's `seed` (`weights.random_init_` for egomcq and extract,
`weights.training_init_` for pretrain and the fine-tunes). `--device cuda` on a machine
without CUDA raises; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from egovlpv2_torch.core.config import load_train_config
from egovlpv2_torch.data.tokenizer import Tokenizer


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not "
                           "available")
    return device


_A7 = ("the dataset readers and the loader of egovlpv2_tpu/data/, which are "
       "not ported yet (ROADMAP.md A7, data readers and loaders)")
_A8 = ("checkpoint save and resume of pretrain and the fine-tunes, which "
       "are not ported yet (ROADMAP.md A8, checkpoints)")
_A10A = ("the training loop's validation, monitor and early stop, which are "
         "not ported yet (ROADMAP.md A10a, the training loop)")
# Flags of the JAX CLI that the port parses and refuses when given: the
# command -> {flag: (store_true?, what it needs)}.
_NOT_PORTED = {
    "pretrain": {"--meta": (False, _A7), "--data": (False, _A7),
                 "--num_workers": (False, _A7), "--device_norm": (True, _A7),
                 "--neg_param": (False, _A7), "--val_meta": (False, _A7),
                 "--val_data": (False, _A7), "--ckpt_every": (False, _A8),
                 "--val_synthetic": (True, _A10A),
                 "--val_batches": (False, _A10A),
                 "--val_vtc_only": (True, _A10A), "--monitor": (False, _A10A),
                 "--early_stop": (False, _A10A), "--init_val": (True, _A10A)},
    "egomcq": {"--data": (False, _A7), "--num_workers": (False, _A7),
               "--device_norm": (True, _A7)},
    "ft": {"--data": (False, _A7), "--num_workers": (False, _A7),
           "--val_data": (False, _A7), "--val_batch_size": (False, _A7),
           "--classes": (False, _A7), "--sliding_window_stride": (False, _A7),
           "--init_val": (True, _A10A)},
}


def _add_not_ported(parser, command: str) -> None:
    for flag, (switch, _) in _NOT_PORTED[command].items():
        if switch:
            parser.add_argument(flag, action="store_true",
                                help="not ported yet: raises")
        else:
            parser.add_argument(flag, default=None,
                                help="not ported yet: raises")
    parser.set_defaults(not_ported=command)


def _refuse_not_ported(args) -> None:
    """Raises NotImplementedError for the first not-ported flag given."""
    for flag, (_, needs) in _NOT_PORTED[args.not_ported].items():
        if getattr(args, flag.lstrip("-")) not in (None, False):
            raise NotImplementedError(f"{flag} needs {needs}")


def _checkpoint_file(ckpt_path):
    """`--ckpt` as given, once it is known to be no directory: a directory
    is a checkpoint saved by training, which is not ported."""
    if ckpt_path and os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"--ckpt {ckpt_path} is a directory: checkpoints saved by "
            "training (train/checkpoint.py) are not ported yet (ROADMAP.md "
            "A8, checkpoints); pass a reference .pth file")
    return ckpt_path


def _load_checkpoint(model, cfg, ckpt_path) -> None:
    """Overlay the reference-named checkpoint file `ckpt_path` onto
    `model`, in place (the JAX CLI's `_load_params`); None leaves the
    seeded parameters."""
    if not ckpt_path:
        return
    from egovlpv2_torch.train.checkpoint_import import (
        import_reference_checkpoint, load_torch_state_dict)

    state_dict, report = import_reference_checkpoint(
        load_torch_state_dict(ckpt_path), model.state_dict(),
        num_frames=cfg.model.video.num_frames)
    model.load_state_dict(state_dict, strict=True)
    print(f"imported {len(report['imported'])} tensors from {ckpt_path} "
          f"({len(report['skipped'])} skipped)")


def _synthetic_egomcq_batches(cfg, tokenizer_name: str, batch_size: int,
                              n_batches: int):
    """callable(epoch) -> iterator of synthetic EgoMCQ batches
    (video5/ids/mask/answer/type), the draws of the JAX CLI's."""
    tok = Tokenizer(tokenizer_name, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    v = cfg.model.video

    def batches(epoch: int = 0):
        rng = np.random.default_rng(1234 + epoch)
        for _ in range(n_batches):
            enc = tok(["someone does something"] * batch_size)
            yield {
                "video5": rng.standard_normal(
                    (batch_size, 5, v.num_frames, v.img_size, v.img_size,
                     v.in_chans)).astype(np.float32),
                "ids": enc["text_ids"],
                "mask": enc["text_mask"],
                "answer": rng.integers(0, 5, batch_size),
                "type": rng.integers(1, 3, batch_size),
            }

    return batches


def _recorded(step, device: torch.device, record: list):
    """Wraps an eval step: appends (wall seconds from the host batch to the
    end of its device work, the input copy included; its scores as numpy)
    to `record`."""

    def run(*args):
        t0 = time.perf_counter()
        out = step(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record.append((time.perf_counter() - t0,
                       {k: v.cpu().numpy() for k, v in out.items()}))
        return out

    return run


def cmd_egomcq(args) -> dict:
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    from egovlpv2_torch.tasks.egomcq import evaluate_egomcq, make_egomcq_eval_step
    from egovlpv2_torch.weights import random_init_

    _refuse_not_ported(args)
    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if args.meta:
        raise NotImplementedError(
            "EgoMCQ files (--meta) need the dataset readers and the loader "
            "of egovlpv2_tpu/data/, which are not ported yet (ROADMAP.md "
            "A7, data readers and loaders); run without --meta for "
            "synthetic batches")
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    _load_checkpoint(model, cfg, ckpt)
    batches = _synthetic_egomcq_batches(cfg, args.tokenizer, args.batch_size,
                                        args.val_batches)
    record = []
    step = _recorded(make_egomcq_eval_step(model, with_vtm=not args.vtc_only),
                     device, record)
    metrics = evaluate_egomcq(step, batches(0))
    seconds = [sec for sec, _ in record]
    scores = {k: np.concatenate([out[k] for _, out in record])
              for k in record[0][1]}
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    clips = args.batch_size * 5
    print(json.dumps({"device": str(device), "steps": len(seconds),
                      "step_ms": [round(s * 1e3, 3) for s in seconds],
                      "clips_per_step": clips}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return {"metrics": metrics, "scores": scores, "step_seconds": seconds,
            "clips_per_step": clips}


def cmd_extract(args) -> dict:
    """MQ-style dense window features: one .npy/.pt per clip (test_mq.py)."""
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    from egovlpv2_torch.tasks.extract import FeatureExtractor, save_features
    from egovlpv2_torch.weights import random_init_

    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if args.videos:
        raise NotImplementedError(
            "video files (--videos) need the file readers and the eval "
            "transform of egovlpv2_tpu/data/, which are not ported yet "
            "(ROADMAP.md A7, data readers and loaders); pass --synthetic "
            "<n_frames> for seeded frames")
    if not args.synthetic or args.synthetic < 1:
        raise ValueError("extract needs --synthetic <n_frames> (>= 1)")
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    _load_checkpoint(model, cfg, ckpt)
    # normalize on the device: ship compact uint8 windows (4x fewer
    # host-to-device bytes) and apply (x/255 - mean)/std there
    ex = FeatureExtractor(model, inner_batch=args.inner_batch,
                          device_norm="imagenet")
    v = cfg.model.video
    res = args.input_res
    uid = "synthetic"  # the one clip; a file's stem once --videos is ported
    frames = np.random.default_rng(cfg.seed).integers(
        0, 256, (args.synthetic, res, res, v.in_chans), dtype=np.uint8)
    feats = ex.clip_features(frames, v.num_frames)
    save_features(os.path.join(args.out, uid), feats)
    print(f"{uid}: {feats.shape}")
    batches = [{"shape": list(shape), "ms": round(ms, 3)}
               for shape, ms in ex.batch_log]
    print(json.dumps({"device": str(device), "inner_batches": batches}))
    return {"features": {uid: feats}, "inner_batches": ex.batch_log,
            "model": model}


def cmd_pretrain(args) -> dict:
    from egovlpv2_torch.tasks.pretrain import build_pretrain, synthetic_batch

    _refuse_not_ported(args)
    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if not args.synthetic:
        raise NotImplementedError(
            "pre-training on EgoClip files needs the dataset readers and the "
            "loader of egovlpv2_tpu/data/, which are not ported yet "
            "(ROADMAP.md A7, data readers and loaders); pass --synthetic")
    if args.save_dir or args.resume:
        raise NotImplementedError(
            "checkpoint save and resume are not ported yet (ROADMAP.md A8, "
            "checkpoints); run without --save_dir and --resume")
    cfg = load_train_config(args.config, args.set)
    model, _, _, train_step = build_pretrain(cfg, device=device)
    _load_checkpoint(model, cfg, ckpt)
    # the epoch cap in loader samples (trainer_egoclip.py:108), synthetic
    # epochs too; without scene negatives a step takes the global batch
    steps = args.steps_per_epoch
    if cfg.max_samples_per_epoch:
        steps = min(steps, max(1, cfg.max_samples_per_epoch
                               // cfg.global_batch_size))
    logged, seconds = _train_loop(
        args, device, train_step,
        lambda epoch: (synthetic_batch(
            cfg, cfg.global_batch_size,
            np.random.default_rng(epoch * 100003 + i))
            for i in range(steps)))
    return {"model": model, "logged": logged, "step_seconds": seconds,
            "clips_per_step": cfg.global_batch_size}


def _train_loop(args, device, train_step, batches) -> tuple:
    """The epochs of `pretrain` and the fine-tunes over `batches(epoch)`:
    every step is timed on the host's clock from its numpy batch to the end
    of its device work, and every `--log_every`-th prints one JSON line.
    Returns (logged rows, step seconds)."""
    logged, seconds = [], []
    step = 0
    for epoch in range(args.epochs):
        for batch in batches(epoch):
            t0 = time.perf_counter()
            metrics = train_step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            step += 1
            if step % args.log_every == 0:
                row = {"epoch": epoch, "step": step,
                       **{k: float(v) for k, v in metrics.items()},
                       "step_ms": round(seconds[-1] * 1e3, 3)}
                logged.append(row)
                print(json.dumps(row), flush=True)
    return logged, seconds


def cmd_dual_ft(args) -> dict:
    """ft-charades / ft-epic (`args.dataset`): the JAX CLI's `_run_dual_ft`
    on synthetic batches."""
    from egovlpv2_torch.tasks.retrieval import build_dual, synthetic_dual_batch

    _refuse_not_ported(args)
    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if args.save_dir or args.resume:
        raise NotImplementedError(
            "checkpoint save and resume are not ported yet (ROADMAP.md A8, "
            "checkpoints); run without --save_dir and --resume")
    if not args.synthetic or args.meta or args.val_meta or args.device_norm:
        raise NotImplementedError(
            "fine-tuning and validating on Charades-Ego / EK-100 files "
            "(--meta, --val_meta, --device_norm) need the dataset readers "
            "and the loader of egovlpv2_tpu/data/, which are not ported yet "
            "(ROADMAP.md A7, data readers and loaders); pass --synthetic")
    if args.visualize:
        raise NotImplementedError(
            "the retrieval visualizer (--visualize) is not ported yet "
            "(ROADMAP.md A10, the rest of the CLI)")
    cfg = load_train_config(args.config, args.set)
    epic = args.dataset == "epic"
    # retrieval fine-tunes use the small projections + Dual loss
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, projection="small",
                                  projection_dim=256, with_itm_head=False,
                                  with_mlm_head=False),
        loss=dataclasses.replace(
            cfg.loss, type="AdaptiveMaxMargin" if epic else "NormSoftmax"),
        max_text_len=30,  # fine-tunes tokenize at 30 (trainer_epic.py:134)
    )
    model, _, _, train_step = build_dual(cfg, device=device)
    _load_checkpoint(model, cfg, ckpt)
    tok = Tokenizer(args.tokenizer, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)

    def batches(epoch):
        rng = np.random.default_rng(epoch)
        for _ in range(args.steps_per_epoch):
            yield synthetic_dual_batch(cfg, cfg.global_batch_size, rng, tok,
                                       relevancy=epic)

    logged, seconds = _train_loop(args, device, train_step, batches)
    return {"model": model, "config": cfg, "logged": logged,
            "step_seconds": seconds, "clips_per_step": cfg.global_batch_size}


def _emit_metrics(metrics: dict, out) -> None:
    """One JSON line of `metrics` on stdout, and into the file `out`."""
    line = json.dumps({k: float(v) for k, v in metrics.items()})
    print(line)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")


class _TokenizedQA:
    """The QA dataset with each question tokenized into text_ids/text_mask."""

    def __init__(self, ds, tok: Tokenizer):
        self.ds, self.tok = ds, tok

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        enc = self.tok([item.pop("text")])
        item["text_ids"] = enc["text_ids"][0]
        item["text_mask"] = enc["text_mask"][0]
        return item


def cmd_taskqa(args) -> dict:
    """EgoTaskQA: QA json + interval videos -> fused backbone + QA head ->
    overall / per-reasoning-type accuracy (EgoTaskQA/main_end2end.py:84-185,
    with the --resume and --test_only modes of :164-200)."""
    from egovlpv2_torch.downstream.datasets import EgoTaskQADataset
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    from egovlpv2_torch.tasks.orchestrators import run_egotaskqa
    from egovlpv2_torch.weights import training_init_

    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    cfg = load_train_config(args.config, args.set)
    with open(args.answer_set) as f:  # output_dim == len(answers)
        num_answers = len([line for line in f if line.strip()])
    reasoning_types = []
    if args.reasoning_types:
        with open(args.reasoning_types) as f:
            reasoning_types = [line.strip() for line in f if line.strip()]
    tok = Tokenizer(args.tokenizer, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)

    def dataset(qa_json, split):
        return _TokenizedQA(EgoTaskQADataset(
            qa_json, args.videos, num_frames=cfg.model.video.num_frames,
            input_res=cfg.model.video.img_size, split=split), tok)

    backbone = None
    if ckpt:
        # the checkpoint over a seeded model, as the JAX CLI's _load_params
        model = training_init_(EgoVLPv2(cfg.model, device="cpu"),
                               torch.Generator().manual_seed(0))
        _load_checkpoint(model, cfg, ckpt)
        backbone = model.state_dict()
    logged, seconds = [], []

    def on_step(step, metrics, sec):
        seconds.append(sec)
        row = {"step": step, **metrics, "step_ms": round(sec * 1e3, 3)}
        logged.append(row)
        print(json.dumps(row), flush=True)

    metrics = run_egotaskqa(
        cfg.model, dataset(args.qa_train, "train"), dataset(args.qa_val, "val"),
        num_answers, reasoning_types=reasoning_types, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, save_dir=args.save_dir,
        resume=args.resume, test_only=args.test_only,
        backbone_state_dict=backbone, device=device, on_step=on_step)
    _emit_metrics(metrics, args.metrics_out)
    return {"metrics": metrics, "logged": logged, "step_seconds": seconds,
            "clips_per_step": args.batch_size}


def main(argv=None):
    parser = argparse.ArgumentParser("egovlpv2-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pretrain")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=10)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--ckpt", default=None, help="reference .pth to import")
    p.add_argument("--save_dir", default=None, help="not ported yet: raises")
    p.add_argument("--resume", action="store_true",
                   help="not ported yet: raises")
    p.add_argument("--tokenizer", default="roberta-base")
    p.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    _add_not_ported(p, "pretrain")
    p.set_defaults(fn=cmd_pretrain)

    e = sub.add_parser("egomcq")
    e.add_argument("--config", default=None)
    e.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    e.add_argument("--tokenizer", default="roberta-base")
    e.add_argument("--meta", default=None, help="not ported yet: raises")
    e.add_argument("--ckpt", default=None, help="reference .pth to import")
    e.add_argument("--batch_size", type=int, default=4)
    e.add_argument("--val_batches", type=int, default=2,
                   help="synthetic-mode batch count")
    e.add_argument("--vtc_only", action="store_true")
    e.add_argument("--out", default=None, help="write metrics JSON here")
    e.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    _add_not_ported(e, "egomcq")
    e.set_defaults(fn=cmd_egomcq)

    x = sub.add_parser("extract")
    x.add_argument("--config", default=None)
    x.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    x.add_argument("--ckpt", default=None, help="reference .pth to import")
    x.add_argument("--videos", default=None,
                   help="glob of video files; not ported yet: raises")
    x.add_argument("--synthetic", type=int, default=None, metavar="N_FRAMES",
                   help="seeded uint8 frames in place of --videos, one clip")
    x.add_argument("--out", required=True, help="output feature dir")
    x.add_argument("--inner_batch", type=int, default=64)
    x.add_argument("--input_res", type=int, default=224)
    x.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    x.set_defaults(fn=cmd_extract)

    for name, dataset in (("ft-charades", "charades"), ("ft-epic", "epic")):
        f = sub.add_parser(name)
        f.add_argument("--config", default=None)
        f.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
        f.add_argument("--tokenizer", default="roberta-base")
        f.add_argument("--synthetic", action="store_true")
        f.add_argument("--epochs", type=int, default=1)
        f.add_argument("--steps_per_epoch", type=int, default=4)
        f.add_argument("--log_every", type=int, default=1)
        f.add_argument("--ckpt", default=None,
                       help="reference .pth to import")
        for flag in ("--meta", "--val_meta", "--save_dir"):
            f.add_argument(flag, default=None, help="not ported yet: raises")
        for flag in ("--resume", "--device_norm", "--visualize"):
            f.add_argument(flag, action="store_true",
                           help="not ported yet: raises")
        f.add_argument("--device", default="cuda",
                       help="cuda, cuda:<i> or cpu")
        _add_not_ported(f, "ft")
        f.set_defaults(fn=cmd_dual_ft, dataset=dataset)

    t = sub.add_parser("taskqa", help="EgoTaskQA: QA fine-tune + accuracy")
    t.add_argument("--config", default=None)
    t.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    t.add_argument("--tokenizer", default="roberta-base")
    t.add_argument("--qa_train", required=True, help="train QA json")
    t.add_argument("--qa_val", required=True, help="val/test QA json")
    t.add_argument("--videos", required=True, help="interval .mp4 dir")
    t.add_argument("--answer_set", required=True,
                   help="answer_set.txt (one answer per line)")
    t.add_argument("--reasoning_types", default=None,
                   help="all_reasoning_types.txt")
    t.add_argument("--ckpt", default=None,
                   help="pretrained backbone: a reference .pth to import")
    t.add_argument("--save_dir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--test_only", action="store_true")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--lr", type=float, default=2e-4)
    t.add_argument("--metrics_out", default=None)
    t.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    t.set_defaults(fn=cmd_taskqa)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
