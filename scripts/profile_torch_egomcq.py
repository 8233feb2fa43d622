"""Time and profile the PyTorch port's EgoMCQ eval step on one CUDA card.

    python3 scripts/profile_torch_egomcq.py [--frames 16 4] [--steps 6] \
        [--out chiprun_out/profile]

For each frame count, at the full width of configs/eval_egomcq.json
(batch 4 items x 5 candidates, bf16, weights from the config's seed):

  1. timing  — `egovlpv2_torch.cli egomcq` for --steps batches. Each step is
               timed from the host's numpy batch to the end of its device
               work, the input copy included. Prints every step, the
               median of the warm ones (all but the first) and the peak
               device memory of the run.
  2. profile — one more step of the same model under torch.profiler, after
               one warm step. Prints the device time of its kernels by kind,
               the number of device events, and the time of the input copy
               alone (host clock around the step's put, `data/loader.py::
               DevicePut`: pinning and the copy on its stream, then a
               synchronize; median of 3). The device's busy share is
               (kernel time + copy time) over the median warm step of part
               1; the step waits for its copy, so nothing overlaps. The
               profiler's op table goes to <out>/prof_<F>f.txt.

The card's name and power limit (nvidia-smi) head the output.
"""

import argparse
import os
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
from egovlpv2_torch.data.loader import device_put  # noqa: E402
from egovlpv2_torch.models.egovlp import EgoVLPv2  # noqa: E402
from egovlpv2_torch.tasks.egomcq import make_egomcq_eval_step  # noqa: E402
from egovlpv2_torch.weights import random_init_  # noqa: E402
from profile_torch_pretrain import K9_KERNELS, k9_launches  # noqa: E402

CONFIG = "configs/eval_egomcq.json"
BATCH = 4
HAND_KERNELS = ("space_fwd_kernel", "space_fwd_frame_kernel",
                "time_fwd_kernel", "time_fwd_tc_kernel",
                "cls_row_part_kernel",
                "cls_row_merge_kernel")
LN_KERNELS = ("layernorm_fwd_kernel",)
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma")


def _kind(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "memcpy" in name:
        return "memcpy"
    if any(k in kernel_name for k in HAND_KERNELS):
        return "hand kernels (K1/K2/K3)"
    if any(k in kernel_name for k in LN_KERNELS):
        return "hand kernels, LayerNorm (K7)"
    if any(k in kernel_name for k in K9_KERNELS):
        return "hand kernel, fused attention (K9)"
    if any(m in name for m in GEMM_MARKS):
        return "GEMM (cuBLAS)"
    if "reduce_kernel" in name:
        return "reductions"
    return "elementwise and copies"


def time_steps(frames: int, steps: int) -> float:
    """Returns the median warm step in ms."""
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(["egomcq", "--config", CONFIG, "--device", "cuda",
                    "--batch_size", str(BATCH), "--val_batches", str(steps),
                    "--set", f"model.video.num_frames={frames}"])
    ms = [s * 1e3 for s in res["step_seconds"]]
    warm = statistics.median(ms[1:])
    print(f"[timing {frames}f] steps {[round(x, 2) for x in ms]} ms | median "
          f"of {len(ms) - 1} warm {warm:.2f} ms | "
          f"{res['clips_per_step'] / warm * 1e3:.2f} clips/s | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return warm


def _copy_ms(*arrays) -> float:
    put = device_put("cuda")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        put(dict(enumerate(arrays))).wait()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_step(frames: int, warm_ms: float, out_dir: str) -> None:
    cfg = load_train_config(CONFIG, [f"model.video.num_frames={frames}"])
    model = EgoVLPv2(cfg.model, device="cuda").eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    step = make_egomcq_eval_step(model)
    v = cfg.model.video
    rng = np.random.default_rng(0)
    video5 = rng.standard_normal((BATCH, 5, v.num_frames, v.img_size,
                                  v.img_size, v.in_chans)).astype(np.float32)
    ids = rng.integers(3, cfg.model.text.vocab_size,
                       (BATCH, cfg.max_text_len))
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    step(video5, ids, mask)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(video5, ids, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    kinds, events = {}, 0
    for e in table:
        if e.device_type == DeviceType.CUDA:
            kinds[_kind(e.key)] = (kinds.get(_kind(e.key), 0.0)
                                   + e.self_device_time_total / 1e3)
            events += e.count
    kernel_ms = sum(v for k, v in kinds.items() if k != "memcpy")
    copy_ms = _copy_ms(video5, ids, mask)
    split = ", ".join(f"{k} {v:.2f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[profile {frames}f] profiled step wall {wall_ms:.2f} ms | "
          f"{events} device events | by kind (ms): {split} | kernels "
          f"{kernel_ms:.2f} ms + input copy {copy_ms:.2f} ms (host clock) = "
          f"busy {100 * (kernel_ms + copy_ms) / warm_ms:.1f}% of the "
          f"{warm_ms:.2f} ms warm step", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"prof_{frames}f.txt")
    with open(path, "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))
    print(f"[profile {frames}f] K9: {k9_launches(table)}", flush=True)
    print(f"[profile {frames}f] op table: {path}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, nargs="+", default=[16, 4])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_egomcq: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for frames in args.frames:
        profile_step(frames, time_steps(frames, args.steps), args.out)


if __name__ == "__main__":
    main()
