"""Command line of the port (counterpart of `egovlpv2_tpu/cli.py`).

Subcommands:
  pretrain — EgoClip pre-training steps (EgoNCE + MLM + ITM), on EgoClip
             files (--meta, a comma list of tab-separated metadata files
             taken round robin, --data the chunked videos; scene negatives
             with --neg_param, uint8 frames normalised on the device with
             --device_norm, --num_workers decoding threads; batch N+1 is
             copied to the device from a feeder thread while step N runs)
             or on synthetic batches (--synthetic). Prints one JSON line a
             logged step with the loss parts and the step's milliseconds.

    python -m egovlpv2_torch.cli pretrain --device cuda \
        --config configs/pretrain_egoclip.json --meta egoclip.csv \
        --data videos/ --device_norm --num_workers 8
    python -m egovlpv2_torch.cli pretrain --synthetic --device cuda \
        --config configs/pretrain_egoclip.json --steps_per_epoch 8 \
        --set global_batch_size=16 model.remat=false path_remat=false

  egomcq   — EgoMCQ zero-shot validation, on egomcq.json and its videos
             (--meta, --data, --device_norm, --num_workers) or on synthetic
             batches. The flags are those of the JAX CLI's `egomcq`,
             without the JAX multi-host ones, plus --device.

    python -m egovlpv2_torch.cli egomcq --config configs/eval_egomcq.json \
        --device cuda --meta egomcq.json --data videos/ --device_norm

  ft-charades, ft-epic — the dual-encoder fine-tunes (Charades-Ego with
             NormSoftmax, EK-100 MIR with AdaptiveMaxMargin and per-row
             relevancy weights): small projection at 256, no ITM/MLM
             heads, 30 text tokens. On files (--meta the metadata
             directory, --data the videos or frame directories,
             --device_norm, --num_workers; batches prefetched as in
             pretrain) with a validation after each epoch (--val_meta,
             --val_data, --val_batch_size, --classes for Charades-Ego,
             --sliding_window_stride), or on synthetic batches
             (--synthetic). Prints one JSON line a logged step with the
             loss and the step's milliseconds, and one a validation.

    python -m egovlpv2_torch.cli ft-charades --device cuda \
        --config configs/ft_charades.json --meta meta/ --data videos/ \
        --val_meta meta/ --classes classes.txt --device_norm

  extract  — EgoMQ-style dense window features: one [N_windows,
             projection_dim] .npy/.pt a clip, from uint8 frames normalised
             on the device, in inner batches of --inner_batch windows.
             --videos <glob> reads each file whole (uniform frames), rounds
             them back to uint8 and takes the geometric eval transform;
             --synthetic <n_frames> takes seeded uint8 frames instead (one
             clip, `synthetic`). Prints the shape and the milliseconds of
             every inner batch.

    python -m egovlpv2_torch.cli extract --config configs/extract_mq.json \
        --device cuda --videos 'clips/*.mp4' --out feats/ [--ckpt published.pth]

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
multi-host ones, which wait for ROADMAP.md A9): checkpoints of pretrain
and the fine-tunes (`--ckpt <directory>`, `--save_dir`, `--resume`,
`--ckpt_every`: A8); the training loop's validation and monitor
(`--val_meta`, `--val_data`, `--val_synthetic`, `--val_batches` of
pretrain, `--val_vtc_only`, `--monitor`, `--early_stop`, `--init_val`:
A10a); the retrieval visualizer (`--visualize`: A10).

Without a checkpoint every parameter is drawn from a torch.Generator seeded
with the config's `seed` (`weights.random_init_` for egomcq and extract,
`weights.training_init_` for pretrain and the fine-tunes). `--device cuda` on a machine
without CUDA raises; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import json
import os
import time

import numpy as np
import torch

from egovlpv2_torch.core.config import load_train_config
from egovlpv2_torch.data.loader import device_prefetch, device_put
from egovlpv2_torch.data.tokenizer import Tokenizer


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not "
                           "available")
    return device


_A8 = ("checkpoint save and resume of pretrain and the fine-tunes, which "
       "are not ported yet (ROADMAP.md A8, checkpoints)")
_A10A = ("the training loop's validation, monitor and early stop, which are "
         "not ported yet (ROADMAP.md A10a, the training loop)")
# Flags of the JAX CLI that the port parses and refuses when given: the
# command -> {flag: (store_true?, what it needs)}.
_NOT_PORTED = {
    "pretrain": {"--val_meta": (False, _A10A), "--val_data": (False, _A10A),
                 "--ckpt_every": (False, _A8),
                 "--val_synthetic": (True, _A10A),
                 "--val_batches": (False, _A10A),
                 "--val_vtc_only": (True, _A10A), "--monitor": (False, _A10A),
                 "--early_stop": (False, _A10A), "--init_val": (True, _A10A)},
    "ft": {"--init_val": (True, _A10A)},
}


def _add_data(parser) -> None:
    """The data flags of the JAX CLI's `_add_common`."""
    parser.add_argument("--meta", default=None)
    parser.add_argument("--data", default=None)
    parser.add_argument("--num_workers", type=int, default=4)


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


def _make_egomcq_batches(args, cfg, tokenizer_name: str, batch_size: int):
    """callable(epoch) -> iterator of EgoMCQ batches (video5/ids/mask/
    answer/type): from egomcq.json and its videos (--meta, --data) through
    the threaded loader, else the JAX CLI's synthetic draws."""
    tok = Tokenizer(tokenizer_name, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    v = cfg.model.video
    if args.meta:
        from egovlpv2_torch.data.datasets import EgoMCQDataset
        from egovlpv2_torch.data.loader import DataLoader

        ds = EgoMCQDataset(args.meta, args.data, num_frames=v.num_frames,
                           input_res=v.img_size, loading="lax",
                           device_norm=args.device_norm)

        def post(batch):
            enc = tok(batch.pop("text"))
            return {"video5": batch["video5"], "ids": enc["text_ids"],
                    "mask": enc["text_mask"], "answer": batch["answer"],
                    "type": batch["type"]}

        return DataLoader(ds, batch_size, post_fn=post, drop_last=False,
                          num_workers=args.num_workers).epoch

    def batches(epoch: int = 0):
        rng = np.random.default_rng(1234 + epoch)
        for _ in range(args.val_batches):
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

    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    _load_checkpoint(model, cfg, ckpt)
    batches = _make_egomcq_batches(args, cfg, args.tokenizer, args.batch_size)
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
    if bool(args.videos) == bool(args.synthetic):
        raise ValueError("extract needs one of --videos <glob> and "
                         "--synthetic <n_frames>")
    if args.synthetic is not None and args.synthetic < 1:
        raise ValueError("--synthetic needs at least one frame")
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    _load_checkpoint(model, cfg, ckpt)
    # normalize on the device: ship compact uint8 windows (4x fewer
    # host-to-device bytes) and apply (x/255 - mean)/std there
    ex = FeatureExtractor(model, inner_batch=args.inner_batch,
                          device_norm="imagenet")
    v = cfg.model.video
    os.makedirs(args.out, exist_ok=True)
    features = {}
    for uid, frames in _extract_clips(args, cfg):
        feats = ex.clip_features(frames, v.num_frames)
        save_features(os.path.join(args.out, uid), feats)
        print(f"{uid}: {feats.shape}")
        features[uid] = feats
    batches = [{"shape": list(shape), "ms": round(ms, 3)}
               for shape, ms in ex.batch_log]
    print(json.dumps({"device": str(device), "inner_batches": batches}))
    return {"features": features, "inner_batches": ex.batch_log,
            "model": model}


def _extract_clips(args, cfg):
    """(uid, uint8 frames [T, H, W, C]) for each clip of `extract`: every
    file of --videos read whole at uniform frames, rounded back to uint8
    (the decoded source was uint8; resize-then-quantize matches the
    reference's PIL-resize-then-ToTensor semantics) and taken through the
    geometric eval transform, in that order; or the one seeded clip of
    --synthetic."""
    if args.synthetic:
        res = args.input_res
        yield "synthetic", np.random.default_rng(cfg.seed).integers(
            0, 256, (args.synthetic, res, res, cfg.model.video.in_chans),
            dtype=np.uint8)
        return
    from egovlpv2_torch.data import readers, transforms

    paths = sorted(glob.glob(args.videos))
    if not paths:
        raise FileNotFoundError(f"no videos match {args.videos!r}")
    for path in paths:
        uid = os.path.splitext(os.path.basename(path))[0]
        total = readers.get_video_len(path)
        frames, _ = readers.read_frames_cv2(path, max(total, 1),
                                            sample="uniform")
        frames = np.round(np.asarray(frames) * 255.0).astype(np.uint8)
        yield uid, transforms.eval_transform(frames, size=args.input_res,
                                             normalize=False)


def cmd_pretrain(args) -> dict:
    from egovlpv2_torch.tasks.pretrain import build_pretrain, synthetic_batch

    _refuse_not_ported(args)
    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if args.save_dir or args.resume:
        raise NotImplementedError(
            "checkpoint save and resume are not ported yet (ROADMAP.md A8, "
            "checkpoints); run without --save_dir and --resume")
    if not args.synthetic and not args.meta:
        raise ValueError("pretrain needs --meta (EgoClip files) or "
                         "--synthetic")
    cfg = load_train_config(args.config, args.set)
    model, _, _, train_step = build_pretrain(cfg, device=device)
    _load_checkpoint(model, cfg, ckpt)
    # the epoch cap in loader samples (trainer_egoclip.py:108 breaks once
    # (batch_idx+1)*batch_sum exceeds it): scene negatives double the
    # device batch, but the cap counts loader rows
    samples_per_step = cfg.global_batch_size // (
        2 if not args.synthetic and args.neg_param else 1)
    steps_cap = (max(1, cfg.max_samples_per_epoch // samples_per_step)
                 if cfg.max_samples_per_epoch else None)
    if args.synthetic:
        # one put a batch, inline in the step, as the JAX CLI's
        def batches(epoch):
            for i in range(min(args.steps_per_epoch,
                               steps_cap or args.steps_per_epoch)):
                yield synthetic_batch(
                    cfg, cfg.global_batch_size,
                    np.random.default_rng(epoch * 100003 + i))
    else:
        loader = _egoclip_loader(args, cfg, samples_per_step)
        put = device_put(device)

        def batches(epoch):
            # batch N+1 is copied from a feeder thread while step N runs
            return device_prefetch(
                itertools.islice(loader.epoch(epoch), steps_cap), put)

    logged, seconds = _train_loop(args, device, train_step, batches)
    return {"model": model, "logged": logged, "step_seconds": seconds,
            "clips_per_step": cfg.global_batch_size}


def _egoclip_loader(args, cfg, loader_batch: int):
    """The EgoClip files of `pretrain` (--meta, comma-separated metadata
    files, round robin across them a step as BaseMultiDataLoader,
    base_data_loader.py:142) through the threaded loader: `loader_batch`
    rows a batch (scene negatives then double it), tokenized and MLM-masked
    by `pretrain_post_fn`."""
    from egovlpv2_torch.data.datasets import EgoClipDataset
    from egovlpv2_torch.data.loader import (DataLoader, HostShardSampler,
                                            RoundRobinLoader,
                                            pretrain_post_fn)

    tok = Tokenizer(args.tokenizer, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)

    def make_loader(meta_path):
        ds = EgoClipDataset(meta_path, args.data,
                            num_frames=cfg.model.video.num_frames,
                            input_res=cfg.model.video.img_size,
                            neg_param=args.neg_param,
                            device_norm=args.device_norm)
        return DataLoader(ds, loader_batch,
                          sampler=HostShardSampler(len(ds), seed=cfg.seed),
                          num_workers=args.num_workers,
                          post_fn=pretrain_post_fn(tok, cfg.mlm_prob))

    loaders = [make_loader(m) for m in args.meta.split(",")]
    return loaders[0] if len(loaders) == 1 else RoundRobinLoader(loaders)


def _train_loop(args, device, train_step, batches,
                after_epoch=None) -> tuple:
    """The epochs of `pretrain` and the fine-tunes over `batches(epoch)`:
    every step is timed on the host's clock from its `next()` on the batch
    iterator (so a wait on the loader or on the feeder of `device_prefetch`
    counts in it) to the end of its device work, and every `--log_every`-th
    prints one JSON line; `after_epoch(epoch)` runs after each epoch.
    Returns (logged rows, step seconds)."""
    logged, seconds = [], []
    step = 0
    for epoch in range(args.epochs):
        it = iter(batches(epoch))
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
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
        finally:
            if hasattr(it, "close"):  # stops a feeder that runs ahead
                it.close()
        if after_epoch is not None:
            after_epoch(epoch)
    return logged, seconds


def dual_config(cfg, dataset: str, device_norm: bool = False):
    """The TrainConfig of a dual fine-tune of `dataset` ("charades" or
    "epic"), as the JAX CLI's `_run_dual_ft` makes it: small projections at
    256 without ITM/MLM heads, NormSoftmax (Charades-Ego) or
    AdaptiveMaxMargin (EK-100), 30 text tokens; with `device_norm`, uint8
    frames normalised on the device in the dataset's regime (EPIC trains in
    0-255 units, Charades in [0, 1] imagenet)."""
    epic = dataset == "epic"
    model_cfg = dataclasses.replace(cfg.model, projection="small",
                                    projection_dim=256, with_itm_head=False,
                                    with_mlm_head=False)
    if device_norm:
        model_cfg = dataclasses.replace(model_cfg, video=dataclasses.replace(
            model_cfg.video, uint8_norm="epic" if epic else "imagenet"))
    return dataclasses.replace(
        cfg,
        model=model_cfg,
        loss=dataclasses.replace(
            cfg.loss, type="AdaptiveMaxMargin" if epic else "NormSoftmax"),
        max_text_len=30,  # fine-tunes tokenize at 30 (trainer_epic.py:134)
    )


def cmd_dual_ft(args) -> dict:
    """ft-charades / ft-epic (`args.dataset`): the JAX CLI's `_run_dual_ft`,
    on files or on synthetic batches, with a validation after each epoch
    when --val_meta is given."""
    from egovlpv2_torch.tasks.retrieval import build_dual, synthetic_dual_batch

    _refuse_not_ported(args)
    device = _device(args.device)
    ckpt = _checkpoint_file(args.ckpt)
    if args.save_dir or args.resume:
        raise NotImplementedError(
            "checkpoint save and resume are not ported yet (ROADMAP.md A8, "
            "checkpoints); run without --save_dir and --resume")
    if args.visualize:
        raise NotImplementedError(
            "the retrieval visualizer (--visualize) is not ported yet "
            "(ROADMAP.md A10, the rest of the CLI)")
    if not args.synthetic and not args.meta:
        raise ValueError(f"{args.cmd} needs --meta (the dataset's files) or "
                         "--synthetic")
    epic = args.dataset == "epic"
    cfg = dual_config(load_train_config(args.config, args.set), args.dataset,
                      args.device_norm)
    model, _, _, train_step = build_dual(cfg, device=device)
    _load_checkpoint(model, cfg, ckpt)
    tok = Tokenizer(args.tokenizer, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)

    if args.synthetic:
        # one put a batch, inline in the step, as the JAX CLI's
        def batches(epoch):
            rng = np.random.default_rng(epoch)
            for _ in range(args.steps_per_epoch):
                yield synthetic_dual_batch(cfg, cfg.global_batch_size, rng,
                                           tok, relevancy=epic)
    else:
        loader = _dual_loader(args, cfg, tok)
        put = device_put(device)

        def batches(epoch):
            # batch N+1 is copied from a feeder thread while step N runs
            return device_prefetch(loader.epoch(epoch), put)

    run_val = _make_dual_val(args, cfg, model, tok)
    val = []

    def validate(epoch):
        metrics = run_val()
        val.append(metrics)
        print(json.dumps({"epoch": epoch, **{
            f"val_{k}": float(v) for k, v in metrics.items()}}), flush=True)

    logged, seconds = _train_loop(args, device, train_step, batches,
                                  after_epoch=validate if run_val else None)
    return {"model": model, "config": cfg, "logged": logged,
            "step_seconds": seconds, "clips_per_step": cfg.global_batch_size,
            "val": val}


def _dual_loader(args, cfg, tok):
    """The training files of a dual fine-tune through the threaded loader,
    tokenized: Charades-Ego videos and metadata_train.csv, or EK-100 frame
    directories and EPIC_100_retrieval_train.csv (with the caption
    relevancy, where its pickle is there)."""
    from egovlpv2_torch.data.datasets import (CharadesEgoDataset,
                                              EpicKitchensMIRDataset)
    from egovlpv2_torch.data.loader import DataLoader, HostShardSampler

    dataset = (EpicKitchensMIRDataset if args.dataset == "epic"
               else CharadesEgoDataset)
    ds = dataset(args.meta, args.data, split="train",
                 num_frames=cfg.model.video.num_frames,
                 input_res=cfg.model.video.img_size,
                 device_norm=args.device_norm)

    def post(batch):
        batch.update(tok(batch.pop("text")))
        return batch

    return DataLoader(ds, cfg.global_batch_size,
                      sampler=HostShardSampler(len(ds), seed=cfg.seed),
                      num_workers=args.num_workers, post_fn=post)


def _make_dual_val(args, cfg, model, tok):
    """run_val() -> metrics after each epoch of a dual fine-tune, or None
    without --val_meta: EK-100 MIR's official mAP/nDCG over the test split
    and its relevancy pickle (trainer_epic.py:200-306), or Charades-Ego's
    mAP of the 157 class prompts of --classes over the val split
    (trainer_charades.py:216-274); both take --sliding_window_stride
    (base_dataset.py:82-106)."""
    if not args.val_meta:
        return None
    from egovlpv2_torch.data.datasets import (CharadesEgoDataset,
                                              EpicKitchensMIRDataset)
    from egovlpv2_torch.data.loader import DataLoader
    from egovlpv2_torch.tasks.retrieval import evaluate_charades, evaluate_mir

    val_data = args.val_data or args.data
    v = cfg.model.video
    if args.dataset == "epic":
        import pickle

        import pandas as pd

        ds = EpicKitchensMIRDataset(
            args.val_meta, val_data, split="test", num_frames=v.num_frames,
            input_res=v.img_size,
            sliding_window_stride=args.sliding_window_stride)
        with open(os.path.join(
                args.val_meta, "relevancy",
                "caption_relevancy_EPIC_100_retrieval_test.pkl"), "rb") as f:
            relevancy = np.asarray(pickle.load(f))
        # official column alignment (metric.py:288-305): video ids from
        # EPIC_100_retrieval_test.csv column 0, unique-sentence ids from
        # EPIC_100_retrieval_test_sentence.csv column 0; without the
        # sentence file, the square text x video layout
        video_ids = pd.read_csv(os.path.join(
            args.val_meta, "EPIC_100_retrieval_test.csv")).values[:, 0]
        sent_path = os.path.join(args.val_meta,
                                 "EPIC_100_retrieval_test_sentence.csv")
        sentence_video_ids = None
        if os.path.exists(sent_path):
            sentence_video_ids = pd.read_csv(sent_path).values[:, 0]
        else:
            video_ids = None

        def post(batch):
            batch.update(tok(batch.pop("text")))
            return batch

        def run_val():
            loader = DataLoader(ds, args.val_batch_size, post_fn=post,
                                drop_last=False, num_workers=args.num_workers)
            return evaluate_mir(model, loader.epoch(0), relevancy,
                                video_ids=video_ids,
                                sentence_video_ids=sentence_video_ids)

        return run_val

    if not args.classes:
        raise ValueError(
            "--classes (157 class prompts, one per line) is required when "
            "--val_meta is given for charades validation")
    ds = CharadesEgoDataset(args.val_meta, val_data, split="val",
                            num_frames=v.num_frames, input_res=v.img_size,
                            sliding_window_stride=args.sliding_window_stride)
    with open(args.classes) as f:  # 157 class prompts, one per line
        enc = tok([line.strip() for line in f if line.strip()])

    def run_val():
        loader = DataLoader(ds, args.val_batch_size, drop_last=False,
                            num_workers=args.num_workers)
        return evaluate_charades(model, loader.epoch(0), enc["text_ids"],
                                 enc["text_mask"])

    return run_val


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
    _add_data(p)
    p.add_argument("--device_norm", action="store_true",
                   help="ship uint8 frames and normalize on the device "
                        "(4x fewer host-to-device bytes a batch)")
    p.add_argument("--neg_param", type=int, default=60,
                   help="scene-negative window seconds; 0 disables")
    p.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    _add_not_ported(p, "pretrain")
    p.set_defaults(fn=cmd_pretrain)

    e = sub.add_parser("egomcq")
    e.add_argument("--config", default=None)
    e.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    e.add_argument("--tokenizer", default="roberta-base")
    _add_data(e)
    e.add_argument("--ckpt", default=None, help="reference .pth to import")
    e.add_argument("--batch_size", type=int, default=4)
    e.add_argument("--val_batches", type=int, default=2,
                   help="synthetic-mode batch count")
    e.add_argument("--vtc_only", action="store_true")
    e.add_argument("--device_norm", action="store_true",
                   help="ship uint8 frames and normalize on the device")
    e.add_argument("--out", default=None, help="write metrics JSON here")
    e.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    e.set_defaults(fn=cmd_egomcq)

    x = sub.add_parser("extract")
    x.add_argument("--config", default=None)
    x.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    x.add_argument("--ckpt", default=None, help="reference .pth to import")
    x.add_argument("--videos", default=None, help="glob of video files")
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
        _add_data(f)
        f.add_argument("--synthetic", action="store_true")
        f.add_argument("--device_norm", action="store_true",
                       help="ship uint8 frames and normalize on the device")
        f.add_argument("--epochs", type=int, default=1)
        f.add_argument("--steps_per_epoch", type=int, default=4)
        f.add_argument("--log_every", type=int, default=1)
        f.add_argument("--ckpt", default=None,
                       help="reference .pth to import")
        f.add_argument("--val_meta", default=None,
                       help="epic: test csv + relevancy meta dir; charades: "
                            "meta dir with metadata_val.csv")
        f.add_argument("--val_data", default=None)
        f.add_argument("--val_batch_size", type=int, default=8)
        f.add_argument("--classes", default=None,
                       help="charades: 157 class prompts, one per line")
        f.add_argument("--sliding_window_stride", type=int, default=-1,
                       help="test-time window expansion stride (-1 = off)")
        f.add_argument("--save_dir", default=None,
                       help="not ported yet: raises")
        for flag in ("--resume", "--visualize"):
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
