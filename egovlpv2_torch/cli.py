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
             After each epoch an EgoMCQ validation (--val_meta/--val_data
             files, or --val_synthetic with --val_batches; --val_vtc_only),
             once before training too with --init_val (with --epochs 0 an
             evaluation alone); --monitor 'max:key' or 'min:key' over the
             epoch's metrics marks the best step and, with --early_stop N,
             stops after N epochs without a better one.

    python -m egovlpv2_torch.cli pretrain --device cuda \\
        --config configs/pretrain_egoclip.json --meta egoclip.csv \\
        --data videos/ --device_norm --num_workers 8 --save_dir run/ \\
        --val_meta egomcq.json --val_data videos/ \\
        --monitor max:ensemble/Inter-video
    python -m egovlpv2_torch.cli pretrain --synthetic --device cuda \\
        --config configs/pretrain_egoclip.json --steps_per_epoch 8 \\
        --val_synthetic --set global_batch_size=16 model.remat=false \\
        path_remat=false

  egomcq   — EgoMCQ zero-shot validation, on egomcq.json and its videos
             (--meta, --data, --device_norm, --num_workers) or on synthetic
             batches. The flags are those of the JAX CLI's `egomcq`,
             plus --device.

    python -m egovlpv2_torch.cli egomcq --config configs/eval_egomcq.json \\
        --device cuda --meta egomcq.json --data videos/ --device_norm \\
        [--ckpt run/ckpt]

  ft-charades, ft-epic — the dual-encoder fine-tunes (Charades-Ego with
             NormSoftmax, EK-100 MIR with AdaptiveMaxMargin and per-row
             relevancy weights): small projection at 256, no ITM/MLM
             heads, 30 text tokens. On files (--meta the metadata
             directory, --data the videos or frame directories,
             --device_norm, --num_workers; batches prefetched as in
             pretrain) with a validation after each epoch (--val_meta,
             --val_data, --val_batch_size, --classes for Charades-Ego,
             --sliding_window_stride; once before training too with
             --init_val; --visualize writes EK-100's retrievals as HTML
             pages under save_dir/web), or on synthetic batches
             (--synthetic). Prints one JSON line a logged step with the
             loss and the step's milliseconds, and one a validation.

    python -m egovlpv2_torch.cli ft-charades --device cuda \\
        --config configs/ft_charades.json --meta meta/ --data videos/ \\
        --val_meta meta/ --classes classes.txt --device_norm \\
        --save_dir ft/ --ckpt run/ckpt

  extract  — EgoMQ-style dense window features: one [N_windows,
             projection_dim] .npy/.pt a clip, from uint8 frames normalised
             on the device, in inner batches of --inner_batch windows.
             --videos <glob> reads each file whole (uniform frames), rounds
             them back to uint8 and takes the geometric eval transform;
             --synthetic <n_frames> takes seeded uint8 frames instead (one
             clip, `synthetic`). Prints the shape and the milliseconds of
             every inner batch.

    python -m egovlpv2_torch.cli extract --config configs/extract_mq.json \\
        --device cuda --videos 'clips/*.mp4' --out feats/ [--ckpt published.pth]

  taskqa   — EgoTaskQA: the fused backbone + QA head fine-tuned on QA json
             files over interval videos (`--videos` dir of <interval>.mp4),
             then overall and per-reasoning-type accuracy, printed (and
             written to --metrics_out) as one JSON line; one JSON line a
             training step with its loss and milliseconds. `--save_dir`
             checkpoints every epoch, `--resume` continues from the latest,
             `--test_only` evaluates it. The float32 path runs with TF32 off.

    python -m egovlpv2_torch.cli taskqa --device cuda --qa_train train.json \\
        --qa_val val.json --videos videos/ --answer_set answer_set.txt \\
        --reasoning_types all_reasoning_types.txt --save_dir qa_ckpt

  mq, mq-anno, nlq, qfvs — the downstream heads on extracted features, as
             the JAX CLI's: `mq-anno` converts the official Ego4D moments
             jsons into the clip table that `mq` reads; `mq` trains VSGN,
             keeps the epoch of least validation loss, infers proposals and
             prints detection mAP and retrieval recall (and writes
             detections_postNMS.json, retreival_postNMS.json and
             submission.json under --out); `nlq` trains VSLNet on
             <clip>_<ann>_<q>.npy features and prints R@k and mIoU; `qfvs`
             trains the summary scorer on P0<v>.npz shot features and
             prints the held-out video's F1. Each prints its metrics as one
             JSON line (also into --metrics_out). The heads are float32 and
             run with TF32 off; VSLNet's and the scorer's LayerNorms run
             the LayerNorm kernels on the card.

    python -m egovlpv2_torch.cli mq-anno --moments moments_train.json,\
        moments_val.json --info ego4d.json --features feats/ --out anno.json
    python -m egovlpv2_torch.cli mq --device cuda --anno anno.json \
        --features feats/ --out mq_out/
    python -m egovlpv2_torch.cli nlq --device cuda --train_anno \
        nlq_train.json --val_anno nlq_val.json --features nlq_feats/
    python -m egovlpv2_torch.cli qfvs --device cuda --oracle Oracle_Summaries \
        --tags Dense_per_shot_tags --tags_mat Tags.mat --features qfvs_feats/ \
        --train_videos 1,2,3 --test_video 4

  bench    — pretrain clips/s per card, the JAX package's `bench.py` on
             the port (`bench.py` of this package): full width, bf16, one
             synthetic batch put on the card once, 3 warm and 10 timed
             steps with two in flight, one JSON line (`metric`, `value`,
             `unit`, `vs_baseline`, `detail`). BENCH_BATCH rows a card
             (16), BENCH_REMAT=1 and BENCH_PATH_REMAT=1 from the
             environment; over N processes each rank drives its card with
             BENCH_BATCH rows and rank 0 prints.

    python -m egovlpv2_torch.cli bench --device cuda

Checkpoints of pretrain and the fine-tunes (`train/checkpoint.py`):
`--save_dir` writes the resolved config.json, info.log, stats.txt (a JSON
line a logged step and a validation) and ckpt/: a checkpoint after each
epoch, one every --ckpt_every steps (pretrain), and one on SIGTERM, after
the step in flight, before the command returns. `--resume` goes on after
the last finished epoch saved there, from its parameters, AdamW moments,
scheduler, dropout generator, step and monitor: after an epoch's save the
resumed run is the one that did not stop, bit for bit; after a SIGTERM it
replays the unfinished epoch. A step's time counts neither a save nor a
validation.

`--ckpt` (egomcq, extract, pretrain, the fine-tunes, taskqa) takes a
`<file.pth>` under the reference's names (`train/checkpoint_import.py`,
the temporal embedding inflated to the config's frame count) or the ckpt/
directory of a run of this program (its best step where the monitor
marked one, else its latest; a model with fewer heads takes the
parameters it has).

Over N processes, one device each (`parallel/`): every command takes
--coordinator host:port of process 0 (or a tcp:// or file:// URL) with
--num_processes N and --process_id i, or --multihost alone under a launcher
that sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK
(torchrun). The group starts before any device is touched, over NCCL on
`cuda:<LOCAL_RANK>` (else the --device index) and over gloo with --device
cpu; two ranks on one card are refused. pretrain and the fine-tunes train
data parallel: each rank feeds its contiguous rows of the global batch
(the seeded synthetic batch's, or its `HostShardSampler` share of the
files), every rank computes the loss of the global batch and the gradients
are averaged, so the run equals one process over the global batch; a
SIGTERM to any rank stops them all after one step, rank 0 saves, every
rank reads a --resume checkpoint, and each rank runs the whole validation.
bench runs on every rank too, each with BENCH_BATCH rows of the batch.
The other commands have no data-parallel form: the group ends, rank 0
runs them alone and the other ranks return. Files come from rank 0 alone.

    torchrun --nproc_per_node 8 -m egovlpv2_torch.cli pretrain --multihost \
        --device cuda --config configs/pretrain_egoclip.json --meta a.csv \
        --data videos/ --save_dir run/
    python -m egovlpv2_torch.cli ft-charades --synthetic --device cpu \
        --coordinator localhost:29500 --num_processes 2 --process_id 0

Without a checkpoint every parameter is drawn from a torch.Generator seeded
with the config's `seed` (`weights.random_init_` for egomcq and extract,
`weights.training_init_` for pretrain and the fine-tunes); the heads' from
flax's default initialisers with seed 0 (`weights.flax_init_`), as the JAX
commands draw them. `--device cuda` on a machine without CUDA raises; it
never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from egovlpv2_torch.core.config import load_train_config
from egovlpv2_torch.data.loader import device_prefetch, device_put
from egovlpv2_torch.data.tokenizer import Tokenizer
from egovlpv2_torch.parallel.distributed import (barrier,
                                                 initialize_multihost,
                                                 is_main_process, rank,
                                                 shutdown, world_size)
from egovlpv2_torch.parallel.mesh import local_batch_size, local_rows
from egovlpv2_torch.utils.logging import setup_logging, span


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not "
                           "available")
    return device


def _add_multihost(parser) -> None:
    """The multi-host flags of the JAX CLI's `_add_common`, with its
    defaults: one process a device over `torch.distributed`."""
    parser.add_argument("--multihost", action="store_true",
                        help="start torch.distributed before touching a "
                             "device, from the launcher's RANK, WORLD_SIZE,"
                             " MASTER_ADDR, MASTER_PORT and LOCAL_RANK "
                             "(torchrun)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0, or a tcp:// or "
                             "file:// rendezvous URL (implies --multihost)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def _add_data(parser) -> None:
    """The data flags of the JAX CLI's `_add_common`."""
    parser.add_argument("--meta", default=None)
    parser.add_argument("--data", default=None)
    parser.add_argument("--num_workers", type=int, default=4)


def _save_resolved_config(cfg, save_dir: Optional[str]) -> None:
    """The resolved config as `save_dir/config.json`, from the main process
    (the reference's ConfigParser writes it for every run with a save
    directory, parse_config.py:62-89)."""
    if not save_dir or not is_main_process():
        return
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


class Monitor:
    """The best of one epoch metric and the early stop
    (base_trainer.py:284-292,366-388): spec 'max:key' or 'min:key'."""

    def __init__(self, spec: str, early_stop: int = 0):
        mode, _, key = spec.partition(":")
        if mode not in ("min", "max") or not key:
            raise ValueError(f"monitor spec must be 'min:key' or 'max:key', "
                             f"got {spec!r}")
        self.mode, self.key = mode, key
        self.early_stop = early_stop
        self.best: Optional[float] = None
        self.not_improved = 0

    def update(self, metrics: Dict[str, float]) -> bool:
        """True when this is a new best; a missing key does not improve."""
        val = metrics.get(self.key)
        if val is None:
            self.not_improved += 1
            return False
        improved = (
            self.best is None
            or (self.mode == "max" and val > self.best)
            or (self.mode == "min" and val < self.best)
        )
        if improved:
            self.best = val
            self.not_improved = 0
        else:
            self.not_improved += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.early_stop > 0 and self.not_improved >= self.early_stop

    def state_dict(self) -> Dict[str, Any]:
        return {"mode": self.mode, "key": self.key, "best": self.best,
                "not_improved": self.not_improved}

    def load_state_dict(self, state: Dict[str, Any]) -> bool:
        """Takes the best value and the count saved beside a checkpoint
        (the reference keeps monitor_best in every .pth,
        base_trainer.py:412-436); False, and nothing taken, when the saved
        state monitored another metric."""
        if state.get("mode") != self.mode or state.get("key") != self.key:
            return False
        self.best = state.get("best")
        self.not_improved = int(state.get("not_improved", 0))
        return True


def _checked_ckpt(path):
    """`--ckpt` as given, once a directory is known to hold a checkpoint of
    a training run: checked before a model is built."""
    from egovlpv2_torch.train.checkpoint import CheckpointManager

    if path and os.path.isdir(path) and \
            CheckpointManager(path).latest_step() is None:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return path


# A fine-tune sets up its own projections (small, at its own width): from
# a run with other projections they keep their seeded values.
_OWN_HEADS = ("txt_proj.", "vid_proj.")


def _load_checkpoint(model, cfg, ckpt_path) -> Optional[float]:
    """Overlay `--ckpt` onto `model`, in place (the JAX CLI's
    `_load_params`): a directory saved by a training run of this program,
    or a reference-named checkpoint file; None leaves the seeded
    parameters. Returns the seconds it took, or None."""
    if not ckpt_path:
        return None
    t0 = time.perf_counter()
    if os.path.isdir(ckpt_path):
        _restore_params(model, ckpt_path)
        return time.perf_counter() - t0
    from egovlpv2_torch.train.checkpoint_import import (
        import_reference_checkpoint, load_torch_state_dict)

    state_dict, report = import_reference_checkpoint(
        load_torch_state_dict(ckpt_path), model.state_dict(),
        num_frames=cfg.model.video.num_frames)
    model.load_state_dict(state_dict, strict=True)
    print(f"imported {len(report['imported'])} tensors from {ckpt_path} "
          f"({len(report['skipped'])} skipped)")
    return time.perf_counter() - t0


def _restore_params(model, directory: str) -> None:
    """The parameters of the best (else the latest) checkpoint under
    `directory`, which holds one (`_checked_ckpt`), into `model`. Those the
    model lacks (the ITM and MLM heads
    of a pretrain run, in a dual model) are left out and named; one the
    model has and the checkpoint lacks, or holds at another shape, raises,
    but for a fine-tune's own projections (`_OWN_HEADS`), which keep their
    seeded values."""
    from egovlpv2_torch.train.checkpoint import CheckpointManager

    params = CheckpointManager(directory).restore_params()
    own = model.state_dict()
    kept = sorted(k for k, v in own.items() if k.startswith(_OWN_HEADS)
                  and (k not in params or params[k].shape != v.shape))
    lacking = sorted(k for k in own if k not in params and k not in kept)
    if lacking:
        raise KeyError(f"the checkpoint under {directory} lacks {len(lacking)}"
                       f" parameters of the model: {lacking[:5]}")
    model.load_state_dict({k: own[k] if k in kept else params[k]
                           for k in own}, strict=True)
    left_out = sorted(set(params) - set(own))
    print(f"restored {len(own) - len(kept)} tensors from {directory} "
          f"({len(left_out)} left out: {_names(left_out)}; {len(kept)} of "
          f"the model's own projections kept: {_names(kept)})")


def _names(keys) -> str:
    """The top-level modules of parameter names, for a report."""
    return ", ".join(sorted({k.split(".")[0] for k in keys})) or "none"


def _make_egomcq_batches(args, cfg, tokenizer_name: str, batch_size: int,
                         meta=None, data=None):
    """callable(epoch) -> iterator of EgoMCQ batches (video5/ids/mask/
    answer/type): from egomcq.json and its videos (`meta`, `data`) through
    the threaded loader, else the JAX CLI's synthetic draws (--val_batches
    of them)."""
    tok = Tokenizer(tokenizer_name, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    v = cfg.model.video
    if meta:
        from egovlpv2_torch.data.datasets import EgoMCQDataset
        from egovlpv2_torch.data.loader import DataLoader

        ds = EgoMCQDataset(meta, data, num_frames=v.num_frames,
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


def _record_scores(record: list) -> dict:
    """The scores of a `_recorded` step's batches, concatenated by key."""
    return {k: np.concatenate([out[k] for _, out in record])
            for k in (record[0][1] if record else ())}


def cmd_egomcq(args) -> dict:
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    from egovlpv2_torch.tasks.egomcq import evaluate_egomcq, make_egomcq_eval_step
    from egovlpv2_torch.weights import random_init_

    device = _device(args.device)
    ckpt = _checked_ckpt(args.ckpt)
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    ckpt_seconds = _load_checkpoint(model, cfg, ckpt)
    batches = _make_egomcq_batches(args, cfg, args.tokenizer, args.batch_size,
                                   args.meta, args.data)
    record = []
    step = _recorded(make_egomcq_eval_step(model, with_vtm=not args.vtc_only),
                     device, record)
    metrics = evaluate_egomcq(step, batches(0))
    seconds = [sec for sec, _ in record]
    scores = _record_scores(record)
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    clips = args.batch_size * 5
    print(json.dumps({"device": str(device), "steps": len(seconds),
                      "step_ms": [round(s * 1e3, 3) for s in seconds],
                      "clips_per_step": clips}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return {"metrics": metrics, "scores": scores, "step_seconds": seconds,
            "clips_per_step": clips, "model": model,
            "ckpt_seconds": ckpt_seconds}


def cmd_extract(args) -> dict:
    """MQ-style dense window features: one .npy/.pt per clip (test_mq.py)."""
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    from egovlpv2_torch.tasks.extract import FeatureExtractor, save_features
    from egovlpv2_torch.weights import random_init_

    device = _device(args.device)
    ckpt = _checked_ckpt(args.ckpt)
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

    device = _device(args.device)
    ckpt = _checked_ckpt(args.ckpt)
    if not args.synthetic and not args.meta:
        raise ValueError("pretrain needs --meta (EgoClip files) or "
                         "--synthetic")
    log = setup_logging(args.save_dir if is_main_process() else None)
    cfg = load_train_config(args.config, args.set)
    _save_resolved_config(cfg, args.save_dir)
    monitor = Monitor(args.monitor, args.early_stop) if args.monitor else None
    trainer = build_pretrain(cfg, device=device)
    model = trainer[0]
    _load_checkpoint(model, cfg, ckpt)
    # the epoch cap in loader samples (trainer_egoclip.py:108 breaks once
    # (batch_idx+1)*batch_sum exceeds it): scene negatives double the
    # device batch, but the cap counts loader rows
    pairs = 2 if not args.synthetic and args.neg_param else 1
    samples_per_step = cfg.global_batch_size // pairs
    steps_cap = (max(1, cfg.max_samples_per_epoch // samples_per_step)
                 if cfg.max_samples_per_epoch else None)
    if args.synthetic:
        # one put a batch, inline in the step, as the JAX CLI's; every rank
        # draws the global batch from the same seed and keeps its rows
        def batches(epoch):
            for i in range(min(args.steps_per_epoch,
                               steps_cap or args.steps_per_epoch)):
                yield local_rows(synthetic_batch(
                    cfg, cfg.global_batch_size,
                    np.random.default_rng(epoch * 100003 + i)),
                    cfg.global_batch_size)
    else:
        loader = _egoclip_loader(
            args, cfg, local_batch_size(cfg.global_batch_size) // pairs)
        put = device_put(device)

        def batches(epoch):
            # batch N+1 is copied from a feeder thread while step N runs
            return device_prefetch(
                itertools.islice(loader.epoch(epoch), steps_cap), put)

    run = _fit(args, device, log, cfg, trainer, batches,
               validate=_egomcq_validation(args, cfg, model),
               monitor=monitor, ckpt_every=args.ckpt_every, val_digits=3)
    return {"model": model, "clips_per_step": cfg.global_batch_size, **run}


def _egomcq_validation(args, cfg, model):
    """validate(epoch) -> (EgoMCQ metrics of `model` on `val_batches(epoch)`
    (trainer_egoclip.py:194-195), the `_recorded` record of its eval
    steps): from --val_meta / --val_data, or --val_synthetic; None without
    either. The step runs the model in `eval()`, so dropout draws nothing
    from the training run's generator, and puts `train()` back."""
    if not (args.val_meta or args.val_synthetic):
        return None
    from egovlpv2_torch.tasks.egomcq import (evaluate_egomcq,
                                             make_egomcq_eval_step)

    # never --meta: pretrain's --meta names EgoClip's files
    val_batches = _make_egomcq_batches(args, cfg, args.tokenizer, 4,
                                       args.val_meta,
                                       args.val_data or args.data)
    eval_step = make_egomcq_eval_step(model, with_vtm=not args.val_vtc_only)
    device = next(model.parameters()).device

    def validate(epoch):
        record = []
        metrics = evaluate_egomcq(_recorded(eval_step, device, record),
                                  val_batches(epoch))
        return metrics, record

    return validate


# the host's milliseconds a step that `_fit`'s log line and stats.txt row
# give, as the mean since the last log, and the spans each one sums
# (`train/step.py`, `_train_loop`); across ranks `grad_sync_ms` is the
# gradients' all-reduce that the backward does not hide. A step replayed
# as one CUDA graph has no forward, backward or optimizer span, only
# `replay_ms`; a group with no span since the last log is left out.
PHASE_SPANS = {
    "data_wait_ms": ("egovlpv2.loop.data_wait",),
    "forward_ms": ("egovlpv2.step.forward",),
    "backward_ms": ("egovlpv2.step.backward",),
    "optimizer_ms": ("egovlpv2.step.zero_grad", "egovlpv2.step.optimizer"),
    "grad_sync_ms": ("egovlpv2.optimizer.grad_sync",),
    "replay_ms": ("egovlpv2.step.replay",),
    "sync_ms": ("egovlpv2.loop.sync",),
}


def _fit(args, device, log, cfg, trainer, batches, validate=None,
         monitor=None, ckpt_every=0, val_digits=4) -> dict:
    """The epochs of `pretrain` and the fine-tunes around `_train_loop`, in
    the JAX CLI's order (`cmd_pretrain` and `_run_dual_ft`,
    egovlpv2_tpu/cli.py:237-446,501-696). `trainer` is (model, optimizer,
    scheduler, train_step).

    With --save_dir: stats.txt and ckpt/, a save after each epoch (with the
    epoch's metrics, the best pointer and the monitor's state), every
    `ckpt_every` steps where it is not 0, and after the step in flight when
    SIGTERM arrives (then marked as the epoch before, which a resumed run
    replays). Each logged step's line and stats.txt row carry the host's
    milliseconds a step of `PHASE_SPANS` since the last log. --resume
    restores the latest save and goes on after its epoch.
    `validate(epoch)` runs after each epoch, and with --init_val
    once before the first as `validate(-1)`, which returns its metrics and
    the `_recorded` record of its eval steps (empty where it has none);
    `monitor` reads the epoch's metrics, the last step's and the
    validation's. Returns the logged rows, the steps' seconds, each
    validation's metrics, scores and eval steps' seconds, the seconds of
    each save, restore and validation, and whether SIGTERM ended the
    run.

    Under a process group every rank runs this: a save gathers the ranks'
    dropout generators to rank 0, which writes, and the ranks meet after
    it; every rank restores from the one file; the ranks agree after each
    step whether SIGTERM reached any of them."""
    from egovlpv2_torch.parallel.collectives import any_rank
    from egovlpv2_torch.parallel.distributed import PreemptionGuard
    from egovlpv2_torch.train.checkpoint import (CheckpointManager,
                                                 load_train_state_,
                                                 train_state)
    from egovlpv2_torch.utils.logging import (SpanMeans, StatsWriter,
                                              Throughput)

    model, optimizer, scheduler, train_step = trainer
    parts = (model, optimizer, scheduler, train_step.generator)
    mining = train_step.mining_generator
    main = is_main_process()
    stats = StatsWriter(args.save_dir) if args.save_dir and main else None
    ckpt = (CheckpointManager(os.path.join(args.save_dir, "ckpt"))
            if args.save_dir else None)
    out = {"val": [], "val_scores": [], "val_step_seconds": [],
           "save_seconds": [], "restore_seconds": [], "val_seconds": [],
           "preempted": False}

    def timed(key, fn, *fn_args):
        t0 = time.perf_counter()
        result = fn(*fn_args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[key].append(time.perf_counter() - t0)
        return result

    saved = {"step": None}

    def save(step, **kw):
        def write():
            state = train_state(*parts, step, mining)
            if main:
                ckpt.save(step, state, **kw)
            barrier("ckpt_saved")

        timed("save_seconds", write)
        saved["step"] = step

    start_epoch = step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        step = timed("restore_seconds",
                     lambda: load_train_state_(ckpt.restore(), *parts,
                                               mining))
        # go on after the last finished epoch (base_trainer.py:438-495
        # resumes at checkpoint_epoch + 1)
        last = ckpt.last_epoch()
        start_epoch = last + 1 if last is not None else 0
        log.info("resumed from step %d (epoch %d)", step, start_epoch)
        if monitor:
            state = ckpt.monitor_state()
            if state and monitor.load_state_dict(state):
                log.info("restored monitor: best %s=%s (%d stale)",
                         monitor.key, monitor.best, monitor.not_improved)

    def run_val(epoch, step):
        val, record = timed("val_seconds", validate, epoch)
        out["val"].append(val)
        out["val_scores"].append(_record_scores(record))
        out["val_step_seconds"].append([sec for sec, _ in record])
        shown = {k: round(v, val_digits) for k, v in val.items()}
        if epoch < 0:
            log.info("init val: %s", shown)
        else:
            log.info("epoch %d val: %s", epoch, shown)
        if stats:
            stats.write(step, {f"val_{k}": v for k, v in val.items()})
        print(json.dumps({"epoch": epoch, **{
            f"val_{k}": float(v) for k, v in val.items()}}), flush=True)
        return val

    tp = Throughput(cfg.global_batch_size)
    phases = SpanMeans(PHASE_SPANS)

    def after_step(epoch, step, metrics):
        rates = tp.tick()
        phases.add()
        if step % args.log_every == 0:
            full = {**metrics, **rates, **phases.read()}
            log.info("step %d: %s", step,
                     {k: round(v, 4) for k, v in full.items()})
            if stats:
                stats.write(step, full)
        if ckpt and ckpt_every and step % ckpt_every == 0:
            save(step)
        # every rank stops at this step if any rank was signalled
        if not any_rank(guard.preempted):
            return False
        if ckpt and saved["step"] != step:
            # this epoch is unfinished: a resumed run replays it
            save(step, epoch=epoch - 1)
        log.info("preempted (SIGTERM): saved at step %d, exiting", step)
        out["preempted"] = True
        return True

    def after_epoch(epoch, step, metrics):
        epoch_metrics = dict(metrics)
        if validate is not None:
            epoch_metrics.update(run_val(epoch, step))
        is_best = monitor.update(epoch_metrics) if monitor else False
        if ckpt:
            save(step, metrics=epoch_metrics, is_best=is_best, epoch=epoch)
            if monitor and main:
                ckpt.save_monitor(monitor.state_dict())
        if monitor and monitor.should_stop:
            log.info("early stop at epoch %d (no improvement in %d epochs, "
                     "best %s=%.4f)", epoch, monitor.not_improved,
                     monitor.key, monitor.best)
            return True
        return False

    # SIGTERM sets a flag that the loop polls after each step, and saves
    # from there; the handler is put back on every way out
    guard = PreemptionGuard()
    try:
        barrier("train_start")
        # validate once before any training (base_trainer.py:86; with
        # --epochs 0 the reference's eval-mode configs)
        if args.init_val and validate is not None and start_epoch == 0:
            run_val(-1, step)
        logged, seconds = _train_loop(
            args, device, train_step, batches, after_step=after_step,
            after_epoch=after_epoch, start_epoch=start_epoch, step=step)
    finally:
        guard.restore()
        if stats:
            stats.close()
    if not out["preempted"]:
        log.info("done at step %d", step + len(seconds))
    return {"logged": logged, "step_seconds": seconds, **out}


def _egoclip_loader(args, cfg, loader_batch: int):
    """The EgoClip files of `pretrain` (--meta, comma-separated metadata
    files, round robin across them a step as BaseMultiDataLoader,
    base_data_loader.py:142) through the threaded loader: `loader_batch`
    rows a batch (scene negatives then double it; this rank's share of the
    global batch), tokenized and MLM-masked by `pretrain_post_fn`."""
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
                          sampler=HostShardSampler(len(ds), world_size(),
                                                   rank(), seed=cfg.seed),
                          num_workers=args.num_workers,
                          post_fn=pretrain_post_fn(tok, cfg.mlm_prob))

    loaders = [make_loader(m) for m in args.meta.split(",")]
    return loaders[0] if len(loaders) == 1 else RoundRobinLoader(loaders)


def _train_loop(args, device, train_step, batches, after_step=None,
                after_epoch=None, start_epoch=0, step=0) -> tuple:
    """The epochs `start_epoch` to `args.epochs - 1` over `batches(epoch)`,
    counting steps on from `step`: every step is timed on the host's clock
    from its `next()` on the batch iterator (so a wait on the loader or on
    the feeder of `device_prefetch` counts in it) to the end of its device
    work, and every `--log_every`-th prints one JSON line. Then
    `after_step(epoch, step, metrics)` runs, and after each epoch
    `after_epoch(epoch, step, metrics)`, with the metrics of the last step
    as floats; either ends the loop by returning True. Neither counts in a
    step's time. Returns (logged rows, step seconds)."""
    logged, seconds = [], []
    for epoch in range(start_epoch, args.epochs):
        it = iter(batches(epoch))
        metrics = {}
        try:
            while True:
                t0 = time.perf_counter()
                with span("egovlpv2.loop.data_wait"):
                    batch = next(it, None)
                if batch is None:
                    break
                out = train_step(batch)
                if device.type == "cuda":
                    with span("egovlpv2.loop.sync"):
                        torch.cuda.synchronize(device)
                seconds.append(time.perf_counter() - t0)
                step += 1
                metrics = {k: float(v) for k, v in out.items()}
                if step % args.log_every == 0:
                    row = {"epoch": epoch, "step": step, **metrics,
                           "step_ms": round(seconds[-1] * 1e3, 3)}
                    logged.append(row)
                    print(json.dumps(row), flush=True)
                if after_step is not None and after_step(epoch, step,
                                                         metrics):
                    return logged, seconds
        finally:
            if hasattr(it, "close"):  # stops a feeder that runs ahead
                it.close()
        if after_epoch is not None and after_epoch(epoch, step, metrics):
            break
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

    device = _device(args.device)
    ckpt = _checked_ckpt(args.ckpt)
    if not args.synthetic and not args.meta:
        raise ValueError(f"{args.cmd} needs --meta (the dataset's files) or "
                         "--synthetic")
    log = setup_logging(args.save_dir if is_main_process() else None)
    epic = args.dataset == "epic"
    cfg = dual_config(load_train_config(args.config, args.set), args.dataset,
                      args.device_norm)
    _save_resolved_config(cfg, args.save_dir)
    trainer = build_dual(cfg, device=device)
    model = trainer[0]
    _load_checkpoint(model, cfg, ckpt)
    tok = Tokenizer(args.tokenizer, max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)

    if args.synthetic:
        # one put a batch, inline in the step, as the JAX CLI's; every rank
        # draws the global batch from the same seed and keeps its rows
        def batches(epoch):
            rng = np.random.default_rng(epoch)
            for _ in range(args.steps_per_epoch):
                yield local_rows(synthetic_dual_batch(
                    cfg, cfg.global_batch_size, rng, tok, relevancy=epic),
                    cfg.global_batch_size)
    else:
        loader = _dual_loader(args, cfg, tok)
        put = device_put(device)

        def batches(epoch):
            # batch N+1 is copied from a feeder thread while step N runs
            return device_prefetch(loader.epoch(epoch), put)

    run = _fit(args, device, log, cfg, trainer, batches,
               validate=_make_dual_val(args, cfg, model, tok))
    return {"model": model, "config": cfg,
            "clips_per_step": cfg.global_batch_size, **run}


def _dual_loader(args, cfg, tok):
    """The training files of a dual fine-tune through the threaded loader,
    tokenized: Charades-Ego videos and metadata_train.csv, or EK-100 frame
    directories and EPIC_100_retrieval_train.csv (with the caption
    relevancy, where its pickle is there); this rank's share of each
    global batch."""
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

    return DataLoader(ds, local_batch_size(cfg.global_batch_size),
                      sampler=HostShardSampler(len(ds), world_size(), rank(),
                                               seed=cfg.seed),
                      num_workers=args.num_workers, post_fn=post)


def _make_dual_val(args, cfg, model, tok):
    """validate(epoch) -> (metrics of a dual fine-tune, an empty record of
    eval steps), or None without --val_meta: EK-100 MIR's official
    mAP/nDCG over the test split and its relevancy pickle
    (trainer_epic.py:200-306), or Charades-Ego's mAP of the 157 class
    prompts of --classes over the val split (trainer_charades.py:216-274);
    both take --sliding_window_stride (base_dataset.py:82-106). With
    --visualize and --save_dir, each EK-100 validation also writes a page
    of its retrievals under save_dir/web (trainer_epic.py:293-298)."""
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

        on_sim = None
        texts_seen = []
        if args.visualize and args.save_dir:
            from egovlpv2_torch.utils.visualizer import RetrievalVisualizer

            viz = RetrievalVisualizer(os.path.join(args.save_dir, "web"))
            pages = itertools.count()

            def on_sim(sim_tv, idx):
                # the loader's one producer thread runs `post` in batch
                # order, so texts_seen lines up with the similarity's rows
                n = min(len(texts_seen), sim_tv.shape[0])
                viz.write_epoch(next(pages), texts_seen[:n], sim_tv[:n],
                                gt_indices=list(range(n)))

        def post(batch):
            if on_sim is not None:
                texts_seen.extend(batch["text"])
            batch.update(tok(batch.pop("text")))
            return batch

        def run_val(epoch):
            loader = DataLoader(ds, args.val_batch_size, post_fn=post,
                                drop_last=False, num_workers=args.num_workers)
            texts_seen.clear()
            return evaluate_mir(model, loader.epoch(0), relevancy,
                                video_ids=video_ids,
                                sentence_video_ids=sentence_video_ids,
                                on_sim=on_sim), []

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

    def run_val(epoch):
        loader = DataLoader(ds, args.val_batch_size, drop_last=False,
                            num_workers=args.num_workers)
        return evaluate_charades(model, loader.epoch(0), enc["text_ids"],
                                 enc["text_mask"]), []

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
    ckpt = _checked_ckpt(args.ckpt)
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


def cmd_mq(args) -> dict:
    """EgoMQ: VSGN on extracted features -> proposals -> detection mAP
    (EgoMQ/Train.py:24-65 + Infer/Eval scripts as one entry)."""
    from egovlpv2_torch.tasks.orchestrators import run_egomq

    device, timings = _device(args.device), {}
    metrics = run_egomq(
        args.anno, args.features, args.out, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, step_size=args.step_size,
        gamma=args.gamma, temporal_scale=args.temporal_scale,
        input_feat_dim=args.input_feat_dim, num_levels=args.num_levels,
        window_stride=args.window_stride, use_vss=args.use_vss,
        device=device, timings=timings)
    _emit_metrics(metrics, args.metrics_out)
    return {"metrics": metrics, "timings": timings}


def cmd_mq_anno(args) -> dict:
    """Official Ego4D moments jsons -> the clip-annotation table `mq`
    consumes (EgoMQ/Convert_annotations.py)."""
    from egovlpv2_torch.downstream.mq_data import write_clip_annotations

    counts = write_clip_annotations(args.out, args.moments.split(","),
                                    args.info, feature_dir=args.features)
    print(json.dumps(counts))
    return counts


def cmd_nlq(args) -> dict:
    """EgoNLQ: official nlq json + extracted per-query features -> VSLNet ->
    R@k/mIoU (EgoNLQ/main.py:197-330)."""
    from egovlpv2_torch.downstream.nlq_data import (attach_feature_indices,
                                                    load_nlq_annotations)
    from egovlpv2_torch.tasks.orchestrators import run_egonlq

    device = _device(args.device)
    train_rec = load_nlq_annotations(args.train_anno)
    val_rec = load_nlq_annotations(args.val_anno)
    # window counts come from the extracted feature dumps
    # (<clip>_<ann>_<qidx>.npy written by tasks/extract.extract_nlq_features)
    nw: Dict[str, int] = {}
    for r in train_rec + val_rec:
        if r["clip_uid"] in nw:
            continue
        p = os.path.join(
            args.features,
            f"{r['clip_uid']}_{r['annotation_uid']}_{r['query_idx']}.npy")
        if os.path.exists(p):
            nw[r["clip_uid"]] = int(np.load(p, mmap_mode="r").shape[0])
    train_meta = attach_feature_indices(train_rec, nw)
    val_meta = attach_feature_indices(val_rec, nw)
    gt = {(r["clip_uid"], r["annotation_uid"], r["query_idx"]):
          (r["s_time"], r["e_time"]) for r in val_meta if "s_time" in r}
    timings = {}
    metrics = run_egonlq(
        train_meta, val_meta, args.features, gt, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, max_pos_len=args.max_pos_len,
        video_feature_dim=args.video_feature_dim, device=device,
        timings=timings)
    _emit_metrics(metrics, args.metrics_out)
    return {"metrics": metrics, "timings": timings}


def cmd_qfvs(args) -> dict:
    """QFVS: packed shot features + oracle summaries -> summary scorer ->
    leave-one-out bipartite F1 (QFVS/main.py:37-54)."""
    from egovlpv2_torch.downstream.qfvs_data import (QFVSDataset,
                                                     load_videos_tag)
    from egovlpv2_torch.tasks.orchestrators import run_qfvs

    device = _device(args.device)
    train_ids = [int(x) for x in args.train_videos.split(",")]
    test_id = int(args.test_video)
    feats = {}
    for vid in train_ids + [test_id]:
        with np.load(os.path.join(args.features, f"P0{vid}.npz")) as z:
            feats[str(vid)] = {k: z[k] for k in (
                "seg_len", "feat_concept1", "feat_concept2", "feat_oracle")}

    def dataset(ids):
        return QFVSDataset(args.oracle, args.tags, ids, feats,
                           max_segment_num=args.max_segments,
                           max_frame_num=args.max_shots)

    test_ds = dataset([test_id])
    test_items = [test_ds[i] for i in range(len(test_ds))]
    shots_tag = load_videos_tag(args.tags_mat)[test_id - 1]
    timings = {}
    metrics = run_qfvs(dataset(train_ids), test_items, shots_tag,
                       epochs=args.epochs, lr=args.lr,
                       top_percent=args.top_percent, device=device,
                       timings=timings)
    _emit_metrics(metrics, args.metrics_out)
    return {"metrics": metrics, "timings": timings}


def cmd_bench(args) -> dict:
    from egovlpv2_torch import bench

    return bench.main(_device(args.device))


def _parser() -> argparse.ArgumentParser:
    """The commands and their flags: those of the JAX CLI's parsers, with
    the same defaults, and --device; every command takes the multi-host
    flags."""
    parser = argparse.ArgumentParser("egovlpv2-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pretrain")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    p.add_argument("--tokenizer", default="roberta-base")
    _add_data(p)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device_norm", action="store_true",
                   help="ship uint8 frames and normalize on the device "
                        "(4x fewer host-to-device bytes a batch)")
    p.add_argument("--neg_param", type=int, default=60,
                   help="scene-negative window seconds; 0 disables")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=10)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="go on from the latest checkpoint in save_dir/ckpt")
    p.add_argument("--val_meta", default=None,
                   help="egomcq.json for the per-epoch validation")
    p.add_argument("--val_data", default=None)
    p.add_argument("--val_synthetic", action="store_true")
    p.add_argument("--val_batches", type=int, default=2)
    p.add_argument("--val_vtc_only", action="store_true")
    p.add_argument("--monitor", default="",
                   help="'max:key' or 'min:key' over the epoch metrics, "
                        "e.g. max:ensemble/Inter-video or min:loss_total")
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop after N epochs without improvement (0: off)")
    p.add_argument("--init_val", action="store_true",
                   help="validate once before training (base_trainer.py:86;"
                        " with --epochs 0 the reference's eval mode)")
    p.add_argument("--ckpt", default=None,
                   help="reference .pth to import, or a ckpt/ directory")
    p.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    p.set_defaults(fn=cmd_pretrain)

    e = sub.add_parser("egomcq")
    e.add_argument("--config", default=None)
    e.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    e.add_argument("--tokenizer", default="roberta-base")
    _add_data(e)
    e.add_argument("--ckpt", default=None,
                   help="reference .pth to import, or a ckpt/ directory")
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
    x.add_argument("--ckpt", default=None,
                   help="reference .pth to import, or a ckpt/ directory")
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
        f.add_argument("--ckpt", default=None,
                       help="reference .pth to import, or a ckpt/ directory")
        f.add_argument("--save_dir", default=None)
        f.add_argument("--synthetic", action="store_true")
        f.add_argument("--device_norm", action="store_true",
                       help="ship uint8 frames and normalize on the device")
        f.add_argument("--epochs", type=int, default=1)
        f.add_argument("--steps_per_epoch", type=int, default=4)
        f.add_argument("--log_every", type=int, default=1)
        f.add_argument("--val_meta", default=None,
                       help="epic: test csv + relevancy meta dir; charades: "
                            "meta dir with metadata_val.csv")
        f.add_argument("--val_data", default=None)
        f.add_argument("--val_batch_size", type=int, default=8)
        f.add_argument("--classes", default=None,
                       help="charades: 157 class prompts, one per line")
        f.add_argument("--sliding_window_stride", type=int, default=-1,
                       help="test-time window expansion stride (-1 = off)")
        f.add_argument("--resume", action="store_true",
                       help="go on from the latest checkpoint in "
                            "save_dir/ckpt")
        f.add_argument("--visualize", action="store_true",
                       help="write each EK-100 validation's retrievals as "
                            "an HTML page under save_dir/web")
        f.add_argument("--init_val", action="store_true",
                       help="validate once before training (with --epochs "
                            "0, an evaluation alone)")
        f.add_argument("--device", default="cuda",
                       help="cuda, cuda:<i> or cpu")
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
                   help="pretrained backbone: a reference .pth to import, "
                        "or a ckpt/ directory")
    t.add_argument("--save_dir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--test_only", action="store_true")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--lr", type=float, default=2e-4)
    t.add_argument("--metrics_out", default=None)
    t.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    t.set_defaults(fn=cmd_taskqa)

    m = sub.add_parser("mq", help="EgoMQ: train VSGN + infer + detection mAP")
    m.add_argument("--anno", required=True, help="clip annotation json")
    m.add_argument("--features", required=True, help="extracted feature dir")
    m.add_argument("--out", required=True, help="work/output dir")
    m.add_argument("--epochs", type=int, default=10)
    m.add_argument("--batch_size", type=int, default=16)
    m.add_argument("--lr", type=float, default=1e-4)
    m.add_argument("--step_size", type=int, default=10)
    m.add_argument("--gamma", type=float, default=0.5)
    m.add_argument("--temporal_scale", type=int, default=928)
    m.add_argument("--input_feat_dim", type=int, default=4096)
    m.add_argument("--num_levels", type=int, default=5)
    m.add_argument("--window_stride", type=int, default=None)
    m.add_argument("--use_vss", action="store_true",
                   help="self-stitch short training clips (the model's "
                        "graph always takes VSS neighbours)")
    m.add_argument("--metrics_out", default=None)
    m.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    m.set_defaults(fn=cmd_mq)

    ma = sub.add_parser(
        "mq-anno",
        help="convert official Ego4D moments jsons to clip annotations")
    ma.add_argument("--moments", required=True,
                    help="comma-separated moments_{train,val,test}.json")
    ma.add_argument("--info", required=True,
                    help="ego4d.json video metadata (duration_sec)")
    ma.add_argument("--features", default=None,
                    help="feature dir: skip videos without dumps, record fps")
    ma.add_argument("--out", required=True, help="output clip-annotation json")
    # it touches no card: a group it starts runs gloo on the host
    ma.set_defaults(fn=cmd_mq_anno, device="cpu")

    n = sub.add_parser("nlq", help="EgoNLQ: train VSLNet + official metrics")
    n.add_argument("--train_anno", required=True, help="official nlq_train.json")
    n.add_argument("--val_anno", required=True, help="official nlq_val.json")
    n.add_argument("--features", required=True,
                   help="dir of <clip>_<ann>_<qidx>.npy + *_query.npy dumps")
    n.add_argument("--epochs", type=int, default=10)
    n.add_argument("--batch_size", type=int, default=32)
    n.add_argument("--lr", type=float, default=1e-3)
    n.add_argument("--max_pos_len", type=int, default=256)
    n.add_argument("--video_feature_dim", type=int, default=768)
    n.add_argument("--metrics_out", default=None)
    n.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    n.set_defaults(fn=cmd_nlq)

    q = sub.add_parser("qfvs", help="QFVS: summary scorer + bipartite F1")
    q.add_argument("--oracle", required=True, help="Oracle_Summaries root")
    q.add_argument("--tags", required=True, help="Dense_per_shot_tags root")
    q.add_argument("--tags_mat", required=True, help="Tags.mat path")
    q.add_argument("--features", required=True,
                   help="dir of P0<v>.npz packed shot features")
    q.add_argument("--train_videos", required=True, help="e.g. 1,2,3")
    q.add_argument("--test_video", required=True)
    q.add_argument("--epochs", type=int, default=5)
    q.add_argument("--lr", type=float, default=1e-4)
    q.add_argument("--top_percent", type=float, default=0.02)
    q.add_argument("--max_segments", type=int, default=20)
    q.add_argument("--max_shots", type=int, default=200)
    q.add_argument("--metrics_out", default=None)
    q.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    q.set_defaults(fn=cmd_qfvs)

    b = sub.add_parser("bench", help="pretrain clips/s per card on one "
                       "synthetic batch (BENCH_BATCH, BENCH_REMAT, "
                       "BENCH_PATH_REMAT from the environment)")
    b.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    b.set_defaults(fn=cmd_bench)
    for command in sub.choices.values():
        _add_multihost(command)
    return parser


# the commands that train data parallel over a process group
_DATA_PARALLEL = (cmd_pretrain, cmd_dual_ft, cmd_bench)


def main(argv=None):
    args = _parser().parse_args(argv)
    if not (args.multihost or args.coordinator):
        return args.fn(args)
    # before any command touches a device
    topo = initialize_multihost(args.coordinator, args.num_processes,
                                args.process_id,
                                device=getattr(args, "device", "cuda"))
    if hasattr(args, "device"):
        args.device = str(topo["device"])
    print(f"# multihost: process {topo['process_index']}/"
          f"{topo['process_count']}, {topo['local_devices']} local / "
          f"{topo['global_devices']} global devices ({topo['device']}, "
          f"{topo['backend']})",
          flush=True)
    if args.fn not in _DATA_PARALLEL:
        # rank 0 runs it alone, after the group has ended: no step or save
        # of it starts a collective that the other ranks would not join
        barrier("start")
        shutdown()
        return args.fn(args) if topo["process_index"] == 0 else None
    try:
        out = args.fn(args)
        barrier("exit")
        return out
    finally:
        shutdown()


if __name__ == "__main__":
    main()
