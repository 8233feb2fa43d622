"""Time and profile the PyTorch port's dual-encoder fine-tune step on one
CUDA card.

    python3 scripts/profile_torch_finetune.py [--steps 6] [--batch 8] \
        [--frames 32] [--remat] [--out chiprun_out/profile]

At full width (TimeSformer-B/16 + RoBERTa-base, small projection at 256, no
ITM/MLM heads), `configs/ft_charades.json` (32 frames at 224, S = 6273,
bf16, NormSoftmax at 0.05, 30 text tokens), synthetic batches, weights from
the config's seed; `model.remat` off unless --remat:

  1. timing  — `egovlpv2_torch.cli ft-charades --synthetic` for --steps
               steps. Each step is timed from the host's numpy batch to the
               end of its device work (forward, backward, AdamW), the input
               copy included. Prints every step, the median of the warm ones
               (all but the first two), clips/s and the peak device memory.
  2. profile — one more step of a fresh trainer under torch.profiler, after
               two warm steps: device time by kind, device events and the
               busy share, as `profile_torch_pretrain.py` prints them. The
               op table goes to <out>/prof_finetune.txt.

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

from egovlpv2_torch import cli  # noqa: E402
from egovlpv2_torch.data.tokenizer import Tokenizer  # noqa: E402
from egovlpv2_torch.tasks.retrieval import (build_dual,  # noqa: E402
                                            synthetic_dual_batch)
from profile_torch_pretrain import profile_train_step  # noqa: E402

CONFIG = "configs/ft_charades.json"


def _args(batch: int, frames: int, remat: bool, steps: int) -> list:
    return ["ft-charades", "--synthetic", "--device", "cuda", "--config",
            CONFIG, "--steps_per_epoch", str(steps), "--set",
            f"global_batch_size={batch}", f"model.video.num_frames={frames}",
            f"model.remat={'true' if remat else 'false'}"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_finetune: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    torch.cuda.reset_peak_memory_stats()
    res = cli.main(_args(args.batch, args.frames, args.remat, args.steps))
    ms = [s * 1e3 for s in res["step_seconds"]]
    warm = statistics.median(ms[2:])
    print(f"[timing] steps {[round(x, 2) for x in ms]} ms | median of "
          f"{len(ms) - 2} warm {warm:.2f} ms | "
          f"{res['clips_per_step'] / warm * 1e3:.2f} clips/s | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    cfg = res["config"]
    del res  # the first trainer's memory goes before the second is built
    gc.collect()
    torch.cuda.empty_cache()

    _, _, _, step = build_dual(cfg, device="cuda")
    tok = Tokenizer("roberta-base", max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    data = synthetic_dual_batch(cfg, args.batch, np.random.default_rng(0), tok)
    profile_train_step(step, data, os.path.join(args.out, "prof_finetune.txt"),
                       warm)


if __name__ == "__main__":
    main()
