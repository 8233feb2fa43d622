"""Time and profile the PyTorch port's EgoTaskQA fine-tune step on one CUDA
card.

    python3 scripts/profile_torch_taskqa.py [--steps 6] [--batch 8] \
        [--answers 100] [--out chiprun_out/profile]

At full width (TimeSformer-B/16 with 12 blocks + RoBERTa-base with 12
layers, the last 6 of each fused, and the QA head), `TrainConfig` defaults:
4 frames at 224 (S = 785), float32 compute and parameters, 15 text tokens;
one AdamW group with the warmup-cosine schedule; seeded in-memory items
(`downstream/taskqa.py::synthetic_qa_items`) over a synthetic answer set of
--answers; weights from a seeded generator. TF32 stays off
(`run_egotaskqa` sets it):

  1. timing  — `tasks/orchestrators.py::run_egotaskqa` for one epoch of
               --steps steps, then its evaluation over two batches. Each
               step is timed from the host's numpy batch to the end of its
               device work (forward, backward, AdamW), the input copy
               included. Prints every step, the median of the warm ones
               (all but the first two), clips/s, the peak device memory and
               the kernels' launches a step.
  2. profile — one more step of a fresh model under torch.profiler, after
               two warm steps: device time by kind, device events and the
               busy share, as `profile_torch_pretrain.py` prints them. The
               op table goes to <out>/prof_taskqa.txt.

The card's name and power limit (nvidia-smi) head the output.
"""

import argparse
import gc
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from egovlpv2_torch.core.config import load_train_config  # noqa: E402
from egovlpv2_torch.data.loader import default_collate  # noqa: E402
from egovlpv2_torch.downstream.taskqa import (make_qa_model,  # noqa: E402
                                              make_qa_train_step,
                                              synthetic_qa_items)
from egovlpv2_torch.ops import _kernels  # noqa: E402
from egovlpv2_torch.tasks.orchestrators import run_egotaskqa  # noqa: E402
from egovlpv2_torch.train.optimizer import make_adamw_warmup_cosine  # noqa: E402
from egovlpv2_torch.weights import training_init_  # noqa: E402
from profile_torch_pretrain import profile_train_step  # noqa: E402

REASONING_TYPES = ("descriptive", "predictive", "explanatory",
                   "counterfactual")


def time_run(cfg, steps: int, batch: int, answers: int) -> tuple:
    """Runs `run_egotaskqa` on seeded items; prints the steps, the
    evaluation and the launches a step. Returns (median warm step ms, the
    items)."""
    rng = np.random.default_rng(cfg.seed)
    items = synthetic_qa_items(cfg.model, (steps + 2) * batch, answers,
                               cfg.max_text_len, rng, REASONING_TYPES)
    train, val = items[:steps * batch], items[steps * batch:]
    seconds, per_step = [], []

    def on_step(step, metrics, sec):
        seconds.append(sec)
        per_step.append(dict(_kernels.launch_counts))
        _kernels.reset_launch_counts()

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    metrics = run_egotaskqa(cfg.model, train, val, answers,
                            reasoning_types=REASONING_TYPES, epochs=1,
                            batch_size=batch, device="cuda", on_step=on_step)
    ms = [s * 1e3 for s in seconds]
    warm = statistics.median(ms[2:])
    launches = {k: v for k, v in per_step[-1].items() if v}
    print(f"[timing] steps {[round(x, 2) for x in ms]} ms | median of "
          f"{len(ms) - 2} warm {warm:.2f} ms | {batch / warm * 1e3:.2f} "
          f"clips/s | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
          f"a step {launches} | evaluation {metrics}", flush=True)
    return warm, items


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--answers", type=int, default=100)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_taskqa: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    cfg = load_train_config(None, [])
    warm, items = time_run(cfg, args.steps, args.batch, args.answers)
    gc.collect()
    torch.cuda.empty_cache()

    model = make_qa_model(cfg.model, args.answers, device="cuda")
    init = torch.Generator().manual_seed(0)
    training_init_(model.backbone, init)
    training_init_(model.qa_head, init)
    optimizer, scheduler = make_adamw_warmup_cosine(model, 2e-4, 1, 100)
    step = make_qa_train_step(model, optimizer, scheduler,
                              torch.Generator(device="cuda").manual_seed(1))
    data = default_collate(items[:args.batch])
    data.pop("reasoning_types")
    profile_train_step(step, data, os.path.join(args.out, "prof_taskqa.txt"),
                       warm)


if __name__ == "__main__":
    main()
