"""Command line of the port (counterpart of `egovlpv2_tpu/cli.py`).

Subcommands:
  egomcq — EgoMCQ zero-shot validation, synthetic batches unless --meta is
           given. The flags are those of the JAX CLI's `egomcq`, without
           the JAX multi-host ones, plus --device.

    python -m egovlpv2_torch.cli egomcq --config configs/eval_egomcq.json \
        --device cuda --val_batches 2

Without a checkpoint every parameter is drawn from a torch.Generator seeded
with the config's `seed` (`weights.random_init_`). `--device cuda` on a
machine without CUDA raises; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from egovlpv2_tpu.cli import _make_egomcq_batches, load_train_config


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

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not "
                           "available")
    if args.ckpt:
        raise NotImplementedError(
            "checkpoint import into egovlpv2_torch is not ported yet "
            "(ROADMAP.md A8, checkpoints)")
    cfg = load_train_config(args.config, args.set)
    model = EgoVLPv2(cfg.model, device=device).eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    batches = _make_egomcq_batches(args, cfg, args.tokenizer,
                                   batch_size=args.batch_size)
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


def main(argv=None):
    parser = argparse.ArgumentParser("egovlpv2-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("egomcq")
    e.add_argument("--config", default=None)
    e.add_argument("--set", nargs="*", default=[], help="dotted.key=value")
    e.add_argument("--tokenizer", default="roberta-base")
    e.add_argument("--meta", default=None)
    e.add_argument("--data", default=None)
    e.add_argument("--num_workers", type=int, default=4)
    e.add_argument("--ckpt", default=None, help="not ported yet: raises")
    e.add_argument("--batch_size", type=int, default=4)
    e.add_argument("--val_batches", type=int, default=2,
                   help="synthetic-mode batch count")
    e.add_argument("--vtc_only", action="store_true")
    e.add_argument("--device_norm", action="store_true",
                   help="ship uint8 frames and normalize on device")
    e.add_argument("--out", default=None, help="write metrics JSON here")
    e.add_argument("--device", default="cuda", help="cuda, cuda:<i> or cpu")
    e.set_defaults(fn=cmd_egomcq)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
