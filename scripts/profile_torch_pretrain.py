"""Time and profile the PyTorch port's pretrain step on one CUDA card.

    python3 scripts/profile_torch_pretrain.py [--steps 8] [--batch 16] \
        [--out chiprun_out/profile]

At full width (TimeSformer-B/16 + RoBERTa-base, 6 fused blocks each, ITM
and MLM heads, projection 4096), 4 frames at 224, 15 text tokens, bf16, no
rematerialisation, synthetic batches, weights from the config's seed:

  1. timing  — the step of `egovlpv2_torch.cli pretrain --synthetic` for
               --steps steps, through the CLI's `_train_loop`, over three
               synthetic batches made before the run and taken in turn (the
               CLI makes a batch a step, whose host RNG would count: a step
               is timed from its next() on the batch iterator). So each step
               is timed from its numpy batch to the end of its device work
               (forward, backward, AdamW), the input copy (the inline put)
               included. Prints every step, the median of the warm ones (all
               but the first two), clips/s and the peak device memory.
  2. profile — one more step of a fresh trainer under torch.profiler, after
               two warm steps. Prints the device time of its kernels by
               kind, the number of device events and the device's busy
               share: kernel time over that step's wall time (one stream,
               so nothing overlaps) and, because the profiler slows the
               host, also over the median warm step of phase 1. The
               profiler's op table goes to
               <out>/prof_pretrain.txt.

The card's name and power limit (nvidia-smi) head the output.
"""

import argparse
import itertools
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from egovlpv2_torch import cli  # noqa: E402
from egovlpv2_torch.core.config import load_train_config  # noqa: E402
from egovlpv2_torch.tasks.pretrain import (build_pretrain,  # noqa: E402
                                           synthetic_batch)

# K9's kernels: the many-query forms (i2t) in bf16 (the ring form, and the
# chunked one past 64 keys) and in 3xTF32 (float32 and the other head
# dims), the few-query forms' split kernels (t2i, text self-attention) and
# their merge
K9_KERNELS = ("fused_ring_kernel", "fused_fwd_kernel",
              "fused_tf32_fwd_kernel", "fused_split_kernel",
              "fused_tf32_split_kernel", "fused_merge_kernel")
KINDS = (  # first match wins
    ("memcpy", ("memcpy",)),
    ("hand kernels, forward (K1/K2/K3)", ("space_fwd_kernel", "time_fwd_kernel",
                                           "space_fwd_frame_kernel",
                                           "time_fwd_tc_kernel",
                                           "cls_row_part_kernel",
                                           "cls_row_merge_kernel")),
    ("hand kernels, general divided attention (K10/K11)", (
        "general_fwd_", "general_bwd_")),  # the tiles, passes and merges
    ("hand kernels, backward (K4/K5/K6)", ("bwd_query_kernel",
                                            "bwd_key_kernel",
                                            "space_bwd_frame_kernel",
                                            "time_bwd_kernel",
                                            "cls_row_bwd_part_kernel",
                                            "cls_row_bwd_merge_kernel")),
    ("hand kernels, LayerNorm (K7/K8)", ("layernorm_fwd_kernel",
                                          "layernorm_bwd_kernel",
                                          "layernorm_bwd_sum_kernel")),
    ("hand kernel, fused attention (K9)", K9_KERNELS),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "gemv")),
    ("optimizer (AdamW, foreach)", ("multi_tensor", "adam")),
    ("reductions", ("reduce_kernel",)),
)


def _sets(batch: int) -> list:
    return ["model.compute_dtype=bfloat16", "model.remat=false",
            "path_remat=false", "optim.max_steps=1000",
            f"global_batch_size={batch}"]


def _kind(kernel_name: str) -> str:
    name = kernel_name.lower()
    for kind, marks in KINDS:
        if any(m in name for m in marks):
            return kind
    return "elementwise and copies"


def k9_launches(table) -> str:
    """K9's kernels in a profile's `key_averages()`, by template instance:
    launches and device ms. `fused_ring_kernel` is the many-query form
    (i2t; `fused_fwd_kernel` past 64 keys); `fused_split_kernel` the
    few-query form (text self-attention and
    t2i together), `fused_merge_kernel` its merge where a call splits the
    keys; `fused_tf32_*` the same in 3xTF32 (float32)."""
    parts = []
    for e in table:
        found = re.search(r"fused_\w+_kernel(<[^>]*>)?", e.key)
        if e.device_type == DeviceType.CUDA and found \
                and any(k in e.key for k in K9_KERNELS):
            parts.append(f"{found.group(0)} x{e.count} "
                         f"{e.self_device_time_total / 1e3:.3f} ms")
    return "; ".join(sorted(parts)) or "none"


def timed_steps(step, batches: list, steps: int) -> float:
    """`steps` steps of `step` through the CLI's `_train_loop` over
    `batches` taken in turn; prints every step's time, the median of the
    warm ones (all but the first two), clips/s and the peak device memory,
    and returns that median, ms."""
    torch.cuda.reset_peak_memory_stats()
    args = argparse.Namespace(epochs=1, log_every=steps + 1)  # no lines
    _, seconds = cli._train_loop(
        args, torch.device("cuda"), step,
        lambda _: itertools.islice(itertools.cycle(batches), steps))
    ms = [s * 1e3 for s in seconds]
    warm = statistics.median(ms[2:])
    clips = len(next(iter(batches[0].values())))
    print(f"[timing] steps {[round(x, 2) for x in ms]} ms | median of "
          f"{len(ms) - 2} warm {warm:.2f} ms | {clips / warm * 1e3:.2f} "
          f"clips/s | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return warm


def time_steps(batch: int, steps: int) -> float:
    """Times the pretrain step; returns the median of the warm ones, ms."""
    cfg = load_train_config(None, _sets(batch))
    _, _, _, step = build_pretrain(cfg, device="cuda")
    rng = np.random.default_rng(cfg.seed)
    return timed_steps(step, [synthetic_batch(cfg, batch, rng)
                              for _ in range(3)], steps)


def profile_step(batch: int, out_dir: str, warm_ms: float) -> None:
    cfg = load_train_config(None, _sets(batch))
    _, _, _, step = build_pretrain(cfg, device="cuda")
    data = synthetic_batch(cfg, batch, np.random.default_rng(0))
    profile_train_step(step, data, os.path.join(out_dir, "prof_pretrain.txt"),
                       warm_ms)


def profile_train_step(step, data, path: str, warm_ms: float) -> None:
    """Two warm steps of `step(data)`, then one under torch.profiler: prints
    its device time by kind, its device events and the busy share, and
    writes the op table to `path`."""
    for _ in range(2):
        step(data)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    kinds, events = {}, 0
    for e in table:
        if e.device_type == DeviceType.CUDA:
            kinds[_kind(e.key)] = (kinds.get(_kind(e.key), 0.0)
                                   + e.self_device_time_total / 1e3)
            events += e.count
    device_ms = sum(kinds.values())
    split = ", ".join(f"{k} {v:.2f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[profile] profiled step wall {wall_ms:.2f} ms | {events} device "
          f"events | by kind (ms): {split} | device {device_ms:.2f} ms = busy "
          f"{100 * device_ms / wall_ms:.1f}% of the profiled step (the profiler "
          f"slows the host), {100 * device_ms / warm_ms:.1f}% of the median "
          f"warm step of {warm_ms:.2f} ms", flush=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=80))
    print(f"[profile] K9: {k9_launches(table)}", flush=True)
    print(f"[profile] op table: {path}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pretrain: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warm_ms = time_steps(args.batch, args.steps)
    profile_step(args.batch, args.out, warm_ms)


if __name__ == "__main__":
    main()
