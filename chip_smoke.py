#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`egovlpv2_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device   — CUDA present; the card's name and power limit (nvidia-smi);
                TF32 off for matmul and cuDNN.
  2. build    — nvcc builds the kernels of csrc/ into build/egovlpv2_torch/.
  3. kernels  — K1 space, K2 time and K3 CLS-row against their plain
                PyTorch versions on the card, at B=20, H=12, Dh=64,
                S=785 (4 frames) and S=3137 (16 frames), bf16 and f32;
                max abs error <= 2e-2 in bf16 (the kernel keeps P.V in f32
                where the plain version rounds P to bf16) and <= 1e-4 in
                f32 (another summation order); each kernel's time beside
                the plain version's.
  4. tiny     — one small model (depth 4, 2 fused, width 128, 2 heads of
                64, 4 frames of 4x4 patches) from one seeded state_dict on
                the card (kernels) and on the CPU (plain): VTC and VTM agree
                within 1e-3 in f32.
  5. slice    — `egovlpv2_torch.cli egomcq` at full width (TimeSformer-B +
                RoBERTa-base, 6 fused blocks each, ITM head) from
                configs/eval_egomcq.json: 16 frames, batch 4, bf16, then
                4 frames; every score finite and all three kernels launched
                in each run.
Then one JSON line of the kernels and, last, the result line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from egovlpv2_torch import cli
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops.divided import cls_row_reference, grouped_reference
from egovlpv2_torch.tasks.egomcq import make_egomcq_eval_step
from egovlpv2_torch.weights import random_init_

SOURCE = "egovlpv2_torch/csrc/divided_attention.cu"
KERNELS = {  # name -> the TPU kernel body it replaces
    "space_attention_fwd": "egovlpv2_tpu/ops/divided.py:774",
    "time_attention_fwd": "egovlpv2_tpu/ops/divided.py:811",
    "cls_row_attention_fwd": "egovlpv2_tpu/ops/divided.py:359",
}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
B, H, DH, N = 20, 12, 64, 196  # 4 items x 5 candidates, ViT-B heads, 14x14 patches
TIME_ITERS = 20  # timed calls of a kernel or its plain version, after 3 warm


def _time_ms(fn) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIME_ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIME_ITERS


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    cached = _kernels.library_path().exists()
    lib = _kernels.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s "
          f"({'already built' if cached else 'nvcc'}): {lib._name}", flush=True)


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel results,
    with the times taken at the 16-frame bf16 shape of the slice."""
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = DH ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        for frames in (4, 16):
            s = 1 + frames * N
            qkv = torch.randn((B, s, 3, H, DH), generator=gen,
                              device="cuda").to(dtype)
            flat = qkv.view(B, s, 3 * H * DH)
            out = torch.empty((B, s, H * DH), dtype=dtype, device="cuda")
            runs = {
                "space_attention_fwd": (
                    lambda: _kernels.space_attention_fwd(
                        flat, out, num_heads=H, num_frames=frames, scale=scale),
                    lambda: grouped_reference(qkv, scale=scale, axis="space",
                                              num_frames=frames),
                    slice(1, None)),
                "time_attention_fwd": (
                    lambda: _kernels.time_attention_fwd(
                        flat, out, num_heads=H, num_frames=frames, scale=scale),
                    lambda: grouped_reference(qkv, scale=scale, axis="time",
                                              num_frames=frames),
                    slice(1, None)),
                "cls_row_attention_fwd": (
                    lambda: _kernels.cls_row_attention_fwd(
                        flat, out, num_heads=H, scale=scale),
                    lambda: cls_row_reference(qkv, scale=scale),
                    slice(0, 1)),
            }
            for name, (kernel, plain, rows) in runs.items():
                out.fill_(float("nan"))
                kernel()
                torch.cuda.synchronize()
                ref = plain().reshape(B, -1, H * DH)
                got = out[:, rows]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: non-finite output rows")
                err = (got.float() - ref.float()).abs().max().item()
                ms, plain_ms = _time_ms(kernel), _time_ms(plain)
                tag = f"{str(dtype).split('.')[-1]} S={s}"
                print(f"[3 kernels] {name:22s} {tag:14s} max_abs_err={err:.3e} "
                      f"(tol {TOL[dtype]:.0e})  kernel {ms:.4f} ms  plain "
                      f"{plain_ms:.4f} ms", flush=True)
                if not err <= TOL[dtype]:
                    raise AssertionError(f"{name} {tag}: error {err} > "
                                         f"{TOL[dtype]}")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if dtype == torch.bfloat16 and frames == 16:
                    r["ms"], r["plain_ms"] = ms, plain_ms
    return results


def phase_tiny() -> None:
    overrides = [
        "model.video.img_size=64", "model.video.embed_dim=128",
        "model.video.depth=4", "model.video.num_heads=2",
        "model.video.num_frames=4", "model.text.vocab_size=1000",
        "model.text.hidden_size=128", "model.text.num_layers=4",
        "model.text.num_heads=2", "model.text.intermediate_size=256",
        "model.text.max_position_embeddings=40",
        "model.fusion.num_fuse_block=2", "model.fusion.dim_video=128",
        "model.fusion.dim_text=128", "model.fusion.hidden_size=128",
        "model.projection_dim=64",
    ]
    mcfg = cli.load_train_config(None, overrides).model
    cpu_model = random_init_(EgoVLPv2(mcfg, device="cpu"),
                             torch.Generator().manual_seed(1)).eval()
    gpu_model = EgoVLPv2(mcfg, device="cuda").eval()
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    rng = np.random.default_rng(2)
    video5 = rng.standard_normal((2, 5, 4, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 1000, (2, 15))
    ids[:, 0], ids[0, 9:] = 0, 1  # BOS; padding in item 0
    mask = (ids != 1).astype(np.int64)
    outs = {}
    before = dict(_kernels.launch_counts)
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        o = make_egomcq_eval_step(model)(video5, ids, mask)
        outs[dev] = {k: v.cpu() for k, v in o.items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in ("vtc", "vtm")}
    launched = {k: _kernels.launch_counts[k] - before[k] for k in before}
    print(f"[4 tiny] cuda vs cpu max_abs_err {errs} (tol 1e-3), launches "
          f"{launched}", flush=True)
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"tiny model: cuda and cpu disagree: {errs}")
    if not all(launched.values()):
        raise AssertionError(f"tiny model on cuda skipped a kernel: {launched}")


def phase_slice() -> dict:
    base = ["egomcq", "--config", "configs/eval_egomcq.json", "--device",
            "cuda", "--val_batches", "2"]
    _kernels.reset_launch_counts()
    seen = dict(_kernels.launch_counts)
    for label, extra in (("16f", []), ("4f", ["--set",
                                              "model.video.num_frames=4"])):
        res = cli.main(base + extra)
        counts = dict(_kernels.launch_counts)
        grew = {k: counts[k] - seen[k] for k in counts}
        seen = counts
        scores = res["scores"]
        finite = all(np.isfinite(v).all() for v in scores.values())
        steps_ms = [round(x * 1e3, 1) for x in res["step_seconds"]]
        step_s = res["step_seconds"][-1]  # the first step carries warm-up
        shapes = {k: v.shape for k, v in scores.items()}
        print(f"[5 slice] egomcq {label}: metrics {res['metrics']} | step "
              f"{step_s * 1e3:.1f} ms (one sample: the last of steps "
              f"{steps_ms} ms, input copy included) | "
              f"{res['clips_per_step'] / step_s:.2f} clips/s | scores "
              f"{shapes} finite={finite} | launches {grew}", flush=True)
        if not finite or set(scores) != {"vtc", "vtm"}:
            raise AssertionError(f"egomcq {label}: bad scores {scores}")
        if not all(grew.values()):
            raise AssertionError(f"egomcq {label}: a kernel was not launched: "
                                 f"{grew}")
    return seen


def main() -> None:
    name = phase_device()
    phase_build()
    results = phase_kernels()
    phase_tiny()
    launches = phase_slice()
    if "jax" in sys.modules or "flax" in sys.modules:
        raise AssertionError("the port imported jax or flax")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
