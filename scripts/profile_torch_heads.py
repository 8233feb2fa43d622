"""Time and profile the PyTorch port's downstream heads' training steps on one
CUDA card: EgoMQ's VSGN, EgoNLQ's VSLNet and the QFVS summary scorer.

    python3 scripts/profile_torch_heads.py [--heads mq nlq qfvs] [--steps 8] \
        [--out chiprun_out/profile]

At the published widths, float32 with TF32 off, weights from flax's
default initialisers drawn with a seed (`runners.init_head_state`), on
seeded in-memory numpy batches:
  * mq   — VSGN, T=928, 4096-d features, hidden 256, 5 levels, 111
           classes, batch 16 (Adam + StepLR, `runners.make_vsgn_train_step`);
           clips of 232 to 928 frames with 2 to 6 moments; then one window's
           inference and the host's proposals and NMS
           (`mq_infer.proposals_from_outputs`);
  * nlq  — VSLNet, dim 128, 8 heads, max_pos_len 256, 768-d features, 15
           query tokens, batch 32 (two AdamW groups);
  * qfvs — the scorer, d_model 768, 20 segments x 200 shots, a step three
           passes (concept1, concept2, oracle; AdamW, cosine).
For each: every step timed from its numpy batch to the end of its device
work, the median of the warm ones (all but the first two), the peak device
memory and the hand kernels' launches a step; then one more step under
torch.profiler after two warm ones: device time by kind, device events and
the busy share. The op tables go to <out>/prof_<head>.txt. The card's name
and power limit (nvidia-smi) head the output.
"""

import argparse
import gc
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from egovlpv2_torch.downstream import mq_infer, qfvs, runners  # noqa: E402
from egovlpv2_torch.downstream import vsgn, vslnet  # noqa: E402
from egovlpv2_torch.downstream.datasets import nlq_highlight_labels  # noqa: E402
from egovlpv2_torch.ops import _kernels  # noqa: E402
from egovlpv2_torch.train.step import batch_to_device  # noqa: E402

KINDS = (  # first match wins
    ("memcpy", ("memcpy",)),
    ("hand kernels, LayerNorm (K7/K8)", ("layernorm_fwd_kernel",
                                          "layernorm_bwd_kernel",
                                          "layernorm_bwd_sum_kernel")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad",
                             "implicit_gemm", "winograd")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "gemv")),
    ("sort", ("sort",)),
    ("optimizer (Adam/AdamW, foreach)", ("multi_tensor", "adam")),
    ("reductions", ("reduce_kernel",)),
    ("gather and scatter", ("gather", "scatter", "index")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, marks in KINDS:
        if any(m in low for m in marks):
            return kind
    return "elementwise and copies"


def mq_batches(rng, n: int, batch: int = 16, t: int = 928,
               classes: int = 110) -> list:
    out = []
    for _ in range(n):
        num_frms = rng.integers(t // 4, t + 1, batch).astype(np.int32)
        video = rng.standard_normal((batch, t, 4096), dtype=np.float32)
        for i, f in enumerate(num_frms):
            video[i, f:] = 0.0
        gt = np.zeros((batch, 50, 3), np.float32)
        num_gt = rng.integers(2, 7, batch).astype(np.int32)
        for i, g in enumerate(num_gt):
            start = rng.uniform(0, 0.8, g) * num_frms[i] / t
            gt[i, :g, 0] = start
            gt[i, :g, 1] = start + rng.uniform(0.01, 0.15, g)
            gt[i, :g, 2] = rng.integers(1, classes + 1, g)
        out.append({"video": video, "num_frms": num_frms, "gt_bbox": gt,
                    "num_gt": num_gt,
                    "gt_action": (rng.random((batch, t)) < 0.3).astype(np.float32),
                    "gt_start": rng.random((batch, t), dtype=np.float32),
                    "gt_end": rng.random((batch, t), dtype=np.float32)})
    return out


def nlq_batches(rng, n: int, batch: int = 32, length: int = 256,
                tokens: int = 15) -> list:
    out = []
    for _ in range(n):
        valid = rng.integers(length // 2, length + 1, batch)
        v_mask = (np.arange(length)[None] < valid[:, None]).astype(np.int32)
        s_ind = (rng.random(batch) * valid * 0.8).astype(np.int32)
        e_ind = np.minimum(s_ind + rng.integers(1, 30, batch), valid - 1)
        e_ind = e_ind.astype(np.int32)
        out.append({
            "video_features": rng.standard_normal((batch, length, 768),
                                                  dtype=np.float32),
            "v_mask": v_mask,
            "query_features": rng.standard_normal((batch, tokens, 768),
                                                  dtype=np.float32),
            "q_mask": np.ones((batch, tokens), np.int32),
            "s_ind": s_ind, "e_ind": e_ind,
            "h_labels": nlq_highlight_labels(s_ind, e_ind, length)})
    return out


def qfvs_batches(rng, n: int, segments: int = 20, shots: int = 200) -> list:
    out = []
    for _ in range(n):
        seg_len = rng.integers(shots // 2, shots + 1, (1, segments))
        seg_len = seg_len.astype(np.int32)
        batch = {"seg_len": seg_len,
                 "mask": (np.arange(shots)[None, None] < seg_len[..., None])
                 .astype(np.float32)}
        for key in ("concept1", "concept2", "oracle"):
            batch[f"feat_{key}"] = rng.standard_normal(
                (1, segments, shots, 768), dtype=np.float32)
            batch[f"{key}_GT"] = (rng.random((1, segments, shots))
                                  < 0.05).astype(np.float32)
        out.append(batch)
    return out


def build(head: str):
    """(model, step, batches maker) of `head` on the card."""
    device = torch.device("cuda")
    if head == "mq":
        model = vsgn.VSGN(device=device)
        runners.init_head_state(model)
        step = runners.make_vsgn_train_step(model, steps_per_epoch=100)[2]
        return model, step, mq_batches
    if head == "nlq":
        model = vslnet.VSLNet(device=device)
        runners.init_head_state(model)
        step = runners.make_vslnet_train_step(model, num_train_steps=100)[2]
        return model, step, nlq_batches
    model = qfvs.SummaryScorer(device=device)
    generator = runners.init_head_state(model)
    step = runners.make_qfvs_train_step(model, total_steps=100,
                                        generator=generator)[2]
    return model, step, qfvs_batches


def time_steps(head: str, steps: int) -> tuple:
    """Prints every step, the median of the warm ones, the peak memory and
    the launches a step (for mq also one window's inference and the host's
    proposals); returns (that median in ms, the step, a batch)."""
    model, step, make = build(head)
    batches = make(np.random.default_rng(0), 3)
    torch.cuda.reset_peak_memory_stats()
    ms, launches = [], {}
    for i in range(steps):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        step(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    warm = statistics.median(ms[2:])
    print(f"[{head} timing] steps {[round(x, 2) for x in ms]} ms | median of "
          f"{len(ms) - 2} warm {warm:.2f} ms | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches a "
          f"step {launches}", flush=True)
    if head == "mq":
        window = {k: v[:1] for k, v in batches[0].items()
                  if k in ("video", "num_frms")}
        t = batch_to_device(window, torch.device("cuda"))
        predict = mq_infer.make_vsgn_predict(model)
        for _ in range(2):
            t0 = time.perf_counter()
            probs, adjusted, start, end = predict(t["video"], t["num_frms"])
            torch.cuda.synchronize()
            infer_ms = (time.perf_counter() - t0) * 1e3
        arrays = [a[0].cpu().numpy() for a in (probs, adjusted, start, end)]
        t0 = time.perf_counter()
        props = mq_infer.proposals_from_outputs(
            *arrays, int(window["num_frms"][0]), 1.875, "clip", 928)
        host_ms = (time.perf_counter() - t0) * 1e3
        print(f"[mq inference] a window {infer_ms:.2f} ms on the card | "
              f"proposals and NMS {host_ms:.1f} ms on the host, "
              f"{len(props)} proposals", flush=True)
    return warm, step, batches[0]


def profile(head: str, step, batch, warm_ms: float, out: str) -> None:
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    kinds, events = {}, 0
    for e in table:
        if e.device_type == DeviceType.CUDA:
            kind = _kind(e.key)
            kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
            events += e.count
    device_ms = sum(kinds.values())
    split = ", ".join(f"{k} {v:.2f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[{head} profile] profiled step wall {wall_ms:.2f} ms | {events} "
          f"device events | by kind (ms): {split} | device {device_ms:.2f} ms "
          f"= busy {100 * device_ms / wall_ms:.1f}% of the profiled step, "
          f"{100 * device_ms / warm_ms:.1f}% of the median warm step of "
          f"{warm_ms:.2f} ms", flush=True)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"prof_{head}.txt")
    with open(path, "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))
    print(f"[{head} profile] op table: {path}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--heads", nargs="+", default=["mq", "nlq", "qfvs"],
                   choices=["mq", "nlq", "qfvs"])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_heads: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for head in args.heads:
        warm, step, batch = time_steps(head, args.steps)
        profile(head, step, batch, warm, args.out)
        del step, batch
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
