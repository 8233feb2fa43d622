#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`egovlpv2_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device   — CUDA present; the card's name and power limit (nvidia-smi);
                TF32 off for matmul and cuDNN.
  2. build    — nvcc builds the four sources of csrc/ into
                build/egovlpv2_torch/, one compiler a source, side by side.
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bf16 and f32, with its time, the plain version's, one
                library call's (`library_ms`) and its bound. Attention,
                H=12, Dh=64:
                forward K1 space, K2 time, K3 CLS row at B=20, S=785 and
                S=3137 (the EgoMCQ shapes), B=16, S=785 (the pretrain
                step's), B=8, S=6273 (the 32-frame fine-tune's), B=64,
                S=3137 (an MQ or NLQ inner batch) and B=16, S=981 (a QFVS
                inner batch: 5 frames), against the plain version on the
                same values raised to f32 (in bf16 the plain version rounds
                P, and two bf16 results one step apart at a value of 4 or
                more differ by 3.1e-2 already; it is timed in bf16); max abs
                error <= 2e-2 in bf16 and <= 1e-4 in f32 (another summation
                order);
                backward K4 space, K5 time, K6 CLS row at B=16, S=785 and
                S=3137 and B=8, S=6273 against autograd through the plain
                version; max abs
                error of each of dq, dk, dv <= 2e-2 (bf16) / 1e-4 (f32) of
                max |reference| of that tensor, the CLS row and the patch
                rows each by its own maximum (a gradient's scale follows
                the cotangent's, and the CLS key's dk/dv are many times a
                patch key's; the kernels keep P, dP and dS in f32 and
                round only the stores, the plain version rounds P and dS to
                bf16; K6 rounds the dk/dv rows a second time when it adds
                to them).
                LayerNorm K7 forward and K8 backward at R x D = 12,560 x
                768 (the pretrain step's), 50,184 x 768 (the fine-tune's),
                200,768 x 768 (an MQ or NLQ inner batch), 15,696 x 768 (a
                QFVS one), 240 x 768 (text rows) and 301 x 776, eps 1e-5
                and 1e-12,
                against `layernorm_reference` and
                `layernorm_backward_reference`: y and dx within 2e-2 (bf16:
                one rounding step where the f32 values differ in their last
                bits) / 1e-5 (f32: a row's sums in another order) of max
                |reference|, dscale and dbias within 1e-3 of max
                |reference| (f32 sums over the rows in another order); the
                times are taken over input sets that together exceed the
                L2 cache. Library: `F.layer_norm` and its autograd backward.
                Fused attention K9, H=12, Dh=64, against
                `flash_attention_reference` on strided views as the models
                hand them over (q a transposed view of a [B, S, H*Dh]
                projection; k and v slices of one packed projection in i2t):
                text self-attention at B=64, L=15, B=8, L=30 and (QFVS) B=16
                and B=3, L=15; i2t and t2i at B=16, S=785, at B=20, S=3137,
                at B=64, S=3137 (NLQ) and at B=16, S=981 (QFVS), L=15;
                B=16 at Sq=Sk=197 and Sq=Sk=64; with a padding mask where the
                models have one, one batch row fully masked; and an odd case
                (Dh=40, Sq=37, Sk=33, on the CUDA cores in bf16 too); max abs
                error of max |reference| <= 4e-3 in bf16 against the
                reference on the same values in f32, not rounded (the
                kernel keeps P in f32 as the reference does, so what is left
                is the one rounding of the output, at most 2^-8 of the
                largest value) / 1e-4 (f32: another summation order); no
                input copied. Plain: today's
                `attend_plain`. Library: one
                `F.scaled_dot_product_attention` call. Where the host needs
                as long to issue a call as the timer reads, the time is the
                wrapper's host time, not the kernel's, and is marked.
  4. tiny     — one small model (depth 4, 2 fused, width 128, 2 heads of
                64, 4 frames of 4x4 patches) from one seeded state_dict on
                the card (kernels) and on the CPU (plain), f32: EgoMCQ VTC
                and VTM agree within 1e-3; one training step's loss parts
                within 1e-3 and every parameter's gradient within 1e-3 of
                max |cpu gradient|, from the same batch and mined indices,
                dropout 0; the same for one dual fine-tune step (small
                projection, NormSoftmax), without and with per-block
                rematerialisation; all nine kernels launched; then the
                outputs of `FeatureExtractor` (MQ features from uint8 frames,
                NLQ fused features, raw query tokens) and of
                `QFVSExtractor.extract_video` (5 frames a clip) within 1e-3
                of max |cpu output|, the change points (one scene cut in
                the frames) found and equal.
  5. slices   — at full width (TimeSformer-B + RoBERTa-base, 6 fused blocks
                each, ITM and MLM heads, projection 4096), bf16:
                `egovlpv2_torch.cli egomcq` from configs/eval_egomcq.json
                at 16 frames, batch 4 x 5 candidates, then 4 frames: every
                score finite, the five forward kernels launched;
                `egovlpv2_torch.cli pretrain --synthetic`: batch 16, 4
                frames, no remat: every loss part finite at every step,
                parameters changed, all nine kernels launched every step;
                `egovlpv2_torch.cli ft-charades --synthetic` from
                configs/ft_charades.json (32 frames, S=6273, small
                projection at 256, 30 text tokens), batch 8: 5 steps
                without rematerialisation, then 2 steps of a fresh trainer
                with `model.remat` as the file has it: every loss finite,
                parameters changed, K1-K8 launched every step (its text
                attention drops probabilities in training, so K9 stays out);
                the three extraction paths from configs/extract_mq.json (16
                frames, S=3137): `egovlpv2_torch.cli extract --synthetic
                2048` (MQ: 128 windows in two inner batches of 64, uint8 in,
                [128, 4096] out); `extract_nlq_features` with two queries
                over the same frames (fused [128, 768] and the raw query
                tokens [15, 768]); `QFVSExtractor.extract_video` on 400
                frames at 5 frames a clip (80 clips, S=981, inner batch 16,
                two concepts and one oracle prompt): every output finite and
                of its shape, K1, K2, K3 and K7 launched on all three, K9 on
                the two fused ones, no K9 input copied.
Then one JSON line of the kernels and, last, the result line.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.nn import functional as F

from egovlpv2_torch import cli
from egovlpv2_torch.core.config import load_train_config
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.objectives.itm_mining import ITMIndices
from egovlpv2_torch.data.tokenizer import Tokenizer
from egovlpv2_torch.ops import _kernels, flash
from egovlpv2_torch.ops import layernorm as ln
from egovlpv2_torch.ops.attention import attend_plain, make_additive_mask
from egovlpv2_torch.ops.divided import (cls_row_reference,
                                        divided_attention_backward_reference,
                                        grouped_reference)
from egovlpv2_torch.tasks.egomcq import make_egomcq_eval_step
from egovlpv2_torch.tasks.extract import FeatureExtractor, extract_nlq_features
from egovlpv2_torch.tasks.pretrain import synthetic_batch
from egovlpv2_torch.tasks.qfvs_extract import QFVSExtractor
from egovlpv2_torch.tasks.retrieval import dual_loss_fn
from egovlpv2_torch.train import step as train_step_module
from egovlpv2_torch.weights import random_init_, training_init_

FWD_SOURCE = "egovlpv2_torch/csrc/divided_attention.cu"
BWD_SOURCE = "egovlpv2_torch/csrc/divided_attention_bwd.cu"
LN_SOURCE = "egovlpv2_torch/csrc/layernorm.cu"
FLASH_SOURCE = "egovlpv2_torch/csrc/fused_attention.cu"
KERNELS = {  # name -> (source, the TPU kernel body it replaces)
    "space_attention_fwd": (FWD_SOURCE, "egovlpv2_tpu/ops/divided.py:774"),
    "time_attention_fwd": (FWD_SOURCE, "egovlpv2_tpu/ops/divided.py:811"),
    "cls_row_attention_fwd": (FWD_SOURCE, "egovlpv2_tpu/ops/divided.py:359"),
    "space_attention_bwd": (BWD_SOURCE, "egovlpv2_tpu/ops/divided.py:623"),
    "time_attention_bwd": (BWD_SOURCE, "egovlpv2_tpu/ops/divided.py:957"),
    "cls_row_attention_bwd": (BWD_SOURCE, "egovlpv2_tpu/ops/divided.py:377"),
    "layernorm_fwd": (LN_SOURCE, "egovlpv2_tpu/ops/layernorm.py:52"),
    "layernorm_bwd": (LN_SOURCE, "egovlpv2_tpu/ops/layernorm.py:65"),
    "fused_attention_fwd": (FLASH_SOURCE, "egovlpv2_tpu/ops/flash.py:37"),
}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # forward abs, backward rel
H, DH, N = 12, 64, 196  # ViT-B heads, 14x14 patches
# (B, frames)
FWD_CASES = ((20, 4), (20, 16), (16, 4), (8, 32), (64, 16), (16, 5))
BWD_CASES = ((16, 4), (16, 16), (8, 32))
MAIN_CASE = (torch.bfloat16, 16, 4)  # the pretrain step's: the JSON line's times
# LayerNorm: (rows, D); y and dx, then dscale and dbias, of max |reference|
LN_CASES = ((16 * 785, 768), (8 * 6273, 768), (64 * 3137, 768),
            (16 * 981, 768), (240, 768), (301, 776))
LN_MAIN_CASE = (torch.bfloat16, 16 * 785, 768)
LN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LN_SUM_TOL = 1e-3
LN_EPS = (1e-5, 1e-12)
# Fused attention: (label, B, H, Sq, Sk, Dh, layout, masked). Layout "packed":
# k and v are slices of one [B, Sk, 2, H, Dh] projection (i2t); "heads": each
# of q, k, v is a transposed view of its own [B, S, H*Dh] projection.
FLASH_CASES = (
    ("text self", 64, H, 15, 15, DH, "heads", True),
    ("text self", 8, H, 30, 30, DH, "heads", True),
    ("text self", 16, H, 15, 15, DH, "heads", True),
    ("text self", 3, H, 15, 15, DH, "heads", True),
    ("i2t", 16, H, 785, 15, DH, "packed", True),
    ("i2t", 20, H, 3137, 15, DH, "packed", True),
    ("i2t", 64, H, 3137, 15, DH, "packed", True),
    ("i2t", 16, H, 981, 15, DH, "packed", True),
    ("t2i", 16, H, 15, 785, DH, "heads", False),
    ("t2i", 20, H, 15, 3137, DH, "heads", False),
    ("t2i", 64, H, 15, 3137, DH, "heads", False),
    ("t2i", 16, H, 15, 981, DH, "heads", False),
    ("above 32", 16, H, 197, 197, DH, "heads", False),
    ("above 32", 16, H, 64, 64, DH, "heads", True),
    ("odd", 3, 5, 37, 33, 40, "heads", True),
)
FLASH_MAIN_CASE = (torch.bfloat16, "i2t", 16, 785)  # the pretrain step's
# K9 in bf16 is held to the reference on the same values in f32, unrounded:
# P stays f32 in both, so only the output's one rounding is left (2^-8).
FLASH_TOL = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
L2_BYTES = 50e6  # timed LayerNorm calls walk input sets of 4x this in all
TIME_ITERS = 20  # timed calls of a kernel or its plain version, after 3 warm
# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PRETRAIN_STEPS = 6
PRETRAIN_SETS = ["model.compute_dtype=bfloat16", "model.remat=false",
                 "path_remat=false", "optim.max_steps=1000",
                 "global_batch_size=16"]
FINETUNE_CONFIG = "configs/ft_charades.json"
FINETUNE_SETS = ["global_batch_size=8", "optim.max_steps=1000"]
FINETUNE_RUNS = (("ft_charades_32f", "model.remat=false", 5),
                 ("ft_charades_32f_remat", "model.remat=true", 2))
# K9 stays out of the fine-tune: its text attention drops probabilities in
# training, which is the plain path.
FINETUNE_KERNELS = tuple(k for k in KERNELS if k != "fused_attention_fwd")
EXTRACT_CONFIG = "configs/extract_mq.json"
EXTRACT_FRAMES = 2048  # 128 windows of 16 frames: two inner batches of 64
NLQ_QUERIES = ("where did I put the scissors", "what did I pour in the bowl")
QFVS_FRAMES, QFVS_INNER_BATCH = 400, 16
QFVS_CONCEPTS, QFVS_ORACLE = ("cup", "street"), "cup and street"


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


def _time_with_host_ms(fn) -> tuple:
    """`_time_ms` of `fn`, and the host's own time a call in the same loop
    (before it waits for the card): where the two are about equal the
    number is the wrapper's host time, not the kernel's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(TIME_ITERS):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIME_ITERS
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIME_ITERS, host_ms


def bound_ms(name: str, dtype, b: int, s: int, frames: int) -> tuple:
    """The least time the card could take for one call: the larger of the
    bytes the function must move (each input row read once, each output row
    written once) over the memory rate, and its operations (2 a
    multiply-add; the forward has 2 products a (query, key) pair, the
    backward 5 with the recomputed logits) over the peak rate of the dtype.
    Returns (ms, "bytes" or "operations")."""
    e = torch.finfo(dtype).bits // 8
    head_rows = b * H * DH  # elements of one sequence row over all heads
    keys = {"space": N + 1, "time": frames + 1, "cls_row": s}[name.rsplit("_", 2)[0]]
    queries = 1 if name.startswith("cls_row") else s - 1
    if name.endswith("_fwd"):
        rows = queries + 2 * s + queries  # q, k and v in; out
        products = 2
    elif name.startswith("cls_row"):
        # q0, k, v and g0 in; dq0, dk and dv out. That K6 adds in place to
        # the 2 (S - 1) dk/dv rows K4/K5 wrote, and so reads them back, is
        # this design's cost and not the function's.
        rows = 1 + 2 * s + 1 + 1 + 2 * s
        products = 5
    else:
        rows = queries + 2 * s + queries + 3 * queries  # q, k, v, g; dq, dk, dv
        products = 5
    t_bytes = rows * head_rows * e / PEAK_BYTES_S
    t_flops = products * 2 * b * H * queries * keys * DH / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def ln_bound_ms(name: str, dtype, rows: int, d: int) -> tuple:
    """The same for one LayerNorm call on x [rows, d]: the forward reads x,
    scale and bias and writes y; the backward reads x, g and scale and
    writes dx, dscale and dbias. Its arithmetic is float32 on the CUDA
    cores: about 8 operations an element forward (two sums, the
    normalisation, the affine), about 20 backward."""
    e = torch.finfo(dtype).bits // 8
    fwd = name.endswith("_fwd")
    t_bytes = ((2 if fwd else 3) * rows * d * e + (2 if fwd else 3) * d * 4) \
        / PEAK_BYTES_S
    t_flops = (8 if fwd else 20) * rows * d / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def flash_bound_ms(dtype, b: int, h: int, sq: int, sk: int, dh: int,
                   masked: bool) -> tuple:
    """The same for one fused attention call: q, k, v and the [B, Sk] float32
    mask read once, the output written once; 4 * Sq * Sk * Dh operations a
    (batch, head) (two products, 2 a multiply-add)."""
    e = torch.finfo(dtype).bits // 8
    t_bytes = ((2 * sq + 2 * sk) * b * h * dh * e + masked * b * sk * 4) \
        / PEAK_BYTES_S
    t_flops = 4 * b * h * sq * sk * dh / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def _reset_counts() -> None:
    _kernels.reset_launch_counts()
    ln.contiguous_copies.update(x=0, g=0)
    flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)


def _free() -> None:
    """Drop what the last phase left on the card before the next builds."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; nvidia-smi: {smi}", flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    cached = all(p.exists() for p in _kernels.library_paths().values())
    _kernels.load()
    libs = ", ".join(p.name for p in _kernels.library_paths().values())
    print(f"[2 build] {time.perf_counter() - t0:.2f} s "
          f"({'already built' if cached else 'nvcc'}): {libs}", flush=True)


def _grouped_qkv(qkv: torch.Tensor, axis: str, frames: int):
    """q, k, v as one library attention call takes them: the frames (space)
    or patch columns (time) as a batch [B, H, G, L, Dh], the CLS key and
    value concatenated in front of each group's."""
    b, s, _, h, dh = qkv.shape
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def grouped(t):
        t = t[:, :, 1:].reshape(b, h, frames, (s - 1) // frames, dh)
        return t.transpose(2, 3) if axis == "time" else t

    qg, kg, vg = grouped(q), grouped(k), grouped(v)
    g = qg.shape[2]
    kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, dh), kg], dim=3)
    vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, dh), vg], dim=3)
    return qg.contiguous(), kg.contiguous(), vg.contiguous()


def _library_calls(qkv: torch.Tensor, g: torch.Tensor, frames: int) -> dict:
    """name -> a closure over one PyTorch library call that computes the
    kernel's function (`scaled_dot_product_attention`, or its autograd
    backward), on tensors laid out for it beforehand. Timed only."""
    scale = DH ** -0.5
    calls = {}
    q0, k0, v0 = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    groups = {"space": _grouped_qkv(qkv, "space", frames),
              "time": _grouped_qkv(qkv, "time", frames),
              "cls_row": (q0[:, :, :1].contiguous(), k0, v0)}
    b, s = qkv.shape[:2]
    gh = g.transpose(1, 2)  # [B, H, S, Dh]
    cots = {"space": gh[:, :, 1:].reshape(b, H, frames, -1, DH),
            "time": gh[:, :, 1:].reshape(b, H, frames, -1, DH).transpose(2, 3),
            "cls_row": gh[:, :, :1]}
    for axis, (q, k, v) in groups.items():
        calls[f"{axis}_attention_fwd"] = (
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        cot = cots[axis].contiguous()
        calls[f"{axis}_attention_bwd"] = (
            lambda out=out, leaves=leaves, cot=cot: torch.autograd.grad(
                out, leaves, cot, retain_graph=True))
    return calls


def _rel_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(largest abs error, its share of max |ref| on the CLS row, the same
    on the patch rows) over dq, dk, dv of [B, S, 3, H, Dh] tensors. Sequence
    row 0 and rows 1..S-1 are each held to their own max |ref|: the CLS key
    gathers from every query, so its dk/dv are many times a patch key's and
    would hide an error as large as a patch row's values."""
    worst_abs, worst_rel = 0.0, [0.0, 0.0]
    for i in range(3):
        for j, rows in enumerate((slice(0, 1), slice(1, None))):
            r = ref[:, rows, i].float()
            err = (got[:, rows, i].float() - r).abs().max().item()
            worst_abs = max(worst_abs, err)
            worst_rel[j] = max(worst_rel[j], err / max(r.abs().max().item(), 1e-30))
    return worst_abs, worst_rel[0], worst_rel[1]


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel results,
    with the times taken at MAIN_CASE."""
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = DH ** -0.5

    def record(name, dtype, b, frames, err, check, ms, plain_ms, lib_ms):
        s = 1 + frames * N
        least, by = bound_ms(name, dtype, b, s, frames)
        tag = f"{str(dtype).split('.')[-1]} B={b} S={s}"
        print(f"[3 kernels] {name:22s} {tag:20s} err={err:.3e} ({check}, tol "
              f"{TOL[dtype]:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  library {lib_ms:.4f} ms  bound {least:.4f} ms ({by})",
              flush=True)
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (dtype, b, frames) == MAIN_CASE:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=least, bound_by=by, shape=tag)

    for dtype in (torch.bfloat16, torch.float32):
        for b, frames in sorted(set(FWD_CASES) | set(BWD_CASES)):
            s = 1 + frames * N
            qkv = torch.randn((b, s, 3, H, DH), generator=gen,
                              device="cuda").to(dtype)
            g = torch.randn((b, s, H, DH), generator=gen,
                            device="cuda").to(dtype)
            flat, gflat = qkv.view(b, s, 3 * H * DH), g.view(b, s, H * DH)
            library = _library_calls(qkv, g, frames)
            kw = dict(num_heads=H, num_frames=frames, scale=scale)
            ckw = dict(num_heads=H, scale=scale)

            if (b, frames) in FWD_CASES:
                out = torch.empty((b, s, H * DH), dtype=dtype, device="cuda")
                # (kernel, plain version as timed, the same on `x`, rows)
                runs = {
                    "space_attention_fwd": (
                        lambda: _kernels.space_attention_fwd(flat, out, **kw),
                        lambda x=qkv: grouped_reference(
                            x, scale=scale, axis="space", num_frames=frames),
                        slice(1, None)),
                    "time_attention_fwd": (
                        lambda: _kernels.time_attention_fwd(flat, out, **kw),
                        lambda x=qkv: grouped_reference(
                            x, scale=scale, axis="time", num_frames=frames),
                        slice(1, None)),
                    "cls_row_attention_fwd": (
                        lambda: _kernels.cls_row_attention_fwd(flat, out, **ckw),
                        lambda x=qkv: cls_row_reference(x, scale=scale),
                        slice(0, 1)),
                }
                for name, (kernel, plain, rows) in runs.items():
                    out.fill_(float("nan"))
                    kernel()
                    torch.cuda.synchronize()
                    # held to the plain version on the same values in f32
                    ref = plain(qkv.float()).reshape(b, -1, H * DH)
                    got = out[:, rows]
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: non-finite output rows")
                    err = (got.float() - ref.float()).abs().max().item()
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"{name} {dtype} B={b} S={s}: "
                                             f"error {err} > {TOL[dtype]}")
                    record(name, dtype, b, frames, err, "abs", _time_ms(kernel),
                           _time_ms(plain), _time_ms(library[name]))

            if (b, frames) in BWD_CASES:
                dqkv = torch.empty_like(flat)
                for axis in ("space", "time"):
                    name = f"{axis}_attention_bwd"
                    stats, parts = _kernels.attention_bwd_scratch(
                        flat, num_heads=H, num_frames=frames, axis=axis)
                    launch = getattr(_kernels, name)
                    kernel = lambda: launch(flat, gflat, dqkv, stats, parts, **kw)
                    plain = lambda: divided_attention_backward_reference(
                        qkv, g, scale=scale, axis=axis, num_frames=frames,
                        rows="grouped")
                    dqkv.fill_(float("nan"))
                    kernel()
                    torch.cuda.synchronize()
                    got = dqkv.view(b, s, 3, H, DH).clone()
                    if not torch.isnan(got[:, 0]).all():
                        raise AssertionError(f"{name} wrote sequence row 0")
                    # row 0: dq is 0 for the grouped rows; dk/dv of the CLS
                    # key are the sum of the blocks' partials (K6 adds them)
                    got[:, 0, 0] = 0
                    got[:, 0, 1:] = parts.sum(2).permute(0, 2, 1, 3).to(dtype)
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: non-finite gradient")
                    err, rel_cls, rel = _rel_errs(got, plain())
                    if not max(rel_cls, rel) <= TOL[dtype]:
                        raise AssertionError(
                            f"{name} {dtype} B={b} S={s}: relative error CLS "
                            f"row {rel_cls}, patch rows {rel} > {TOL[dtype]}")
                    record(name, dtype, b, frames, err,
                           f"rel cls row {rel_cls:.2e} patch rows {rel:.2e}",
                           _time_ms(kernel), _time_ms(plain),
                           _time_ms(library[name]))
                name = "cls_row_attention_bwd"
                dqkv.zero_()
                _kernels.cls_row_attention_bwd(flat, gflat, dqkv,
                                               torch.zeros_like(parts), **ckw)
                torch.cuda.synchronize()
                plain = lambda: divided_attention_backward_reference(
                    qkv, g, scale=scale, axis="space", num_frames=frames,
                    rows="cls")
                err, rel_cls, rel = _rel_errs(dqkv.view(b, s, 3, H, DH), plain())
                if not max(rel_cls, rel) <= TOL[dtype]:
                    raise AssertionError(
                        f"{name} {dtype} B={b} S={s}: relative error CLS row "
                        f"{rel_cls}, patch rows {rel} > {TOL[dtype]}")
                # timed as the step runs it: adding to rows K4/K5 wrote
                kernel = lambda: _kernels.cls_row_attention_bwd(
                    flat, gflat, dqkv, parts, **ckw)
                record(name, dtype, b, frames, err,
                       f"rel cls row {rel_cls:.2e} patch rows {rel:.2e}",
                       _time_ms(kernel), _time_ms(plain),
                       _time_ms(library[name]))
            del library
            torch.cuda.empty_cache()
    phase_layernorm(results)
    phase_flash(results)
    return results


def phase_layernorm(results: dict) -> None:
    """K7 and K8 against their plain versions at LN_CASES; the times of
    LN_MAIN_CASE go into `results`."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rel(got, ref):
        ref = ref.float()
        return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()

    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in LN_CASES:
            e = torch.finfo(dtype).bits // 8
            n_sets = int(min(8, max(1, -(-4 * L2_BYTES // (3 * rows * d * e)))))
            sets = []
            for _ in range(n_sets):
                # an offset mean: E[x^2] - E[x]^2 is then not a two-pass variance
                x = (torch.randn((rows, d), generator=gen, device="cuda") * 0.7
                     + 1.5).to(dtype)
                g = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
                sets.append((x, g, torch.empty_like(x), torch.empty_like(x)))
            scale = 1 + 0.2 * torch.randn(d, generator=gen, device="cuda")
            bias = 0.2 * torch.randn(d, generator=gen, device="cuda")
            dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
            partials = _kernels.layernorm_bwd_scratch(sets[0][0])
            x, g, y, dx = sets[0]
            errs = {"layernorm_fwd": 0.0, "layernorm_bwd": 0.0}
            checks = {}
            for eps in LN_EPS:
                y.fill_(float("nan"))
                dx.fill_(float("nan"))
                dscale.fill_(float("nan"))
                dbias.fill_(float("nan"))
                _kernels.layernorm_fwd(x, scale, bias, y, eps=eps)
                _kernels.layernorm_bwd(x, scale, g, dx, dscale, dbias, partials,
                                       eps=eps)
                torch.cuda.synchronize()
                ref_y = ln.layernorm_reference(x, scale, bias, eps=eps)
                ref_dx, ref_ds, ref_db = ln.layernorm_backward_reference(
                    x, scale, g, eps)
                for t in (y, dx, dscale, dbias):
                    if not torch.isfinite(t).all():
                        raise AssertionError(f"layernorm {dtype} {rows}x{d} eps "
                                             f"{eps}: non-finite output")
                r_y, r_dx = rel(y, ref_y), rel(dx, ref_dx)
                r_ds, r_db = rel(dscale, ref_ds), rel(dbias, ref_db)
                if not (max(r_y, r_dx) <= LN_TOL[dtype]
                        and max(r_ds, r_db) <= LN_SUM_TOL):
                    raise AssertionError(
                        f"layernorm {dtype} {rows}x{d} eps {eps}: relative "
                        f"error y {r_y}, dx {r_dx} > {LN_TOL[dtype]} or dscale "
                        f"{r_ds}, dbias {r_db} > {LN_SUM_TOL}")
                errs["layernorm_fwd"] = max(
                    errs["layernorm_fwd"], (y.float() - ref_y.float()).abs().max().item())
                errs["layernorm_bwd"] = max(
                    errs["layernorm_bwd"], (dx.float() - ref_dx.float()).abs().max().item())
                checks[eps] = (f"rel y {r_y:.2e}", f"rel dx {r_dx:.2e} dscale "
                               f"{r_ds:.2e} dbias {r_db:.2e}")

            eps = LN_EPS[0]
            turn = {"i": 0}

            def next_set():
                turn["i"] += 1
                return sets[turn["i"] % n_sets]

            # the library call takes its parameters in x's dtype
            w, b = scale.to(dtype), bias.to(dtype)
            graphs = []
            for x_, g_, _, _ in sets:
                leaves = [t.detach().requires_grad_(True) for t in (x_, w, b)]
                graphs.append((F.layer_norm(leaves[0], (d,), leaves[1], leaves[2],
                                            eps), leaves, g_))

            def kernel_fwd():
                x_, _, y_, _ = next_set()
                _kernels.layernorm_fwd(x_, scale, bias, y_, eps=eps)

            def kernel_bwd():
                x_, g_, _, dx_ = next_set()
                _kernels.layernorm_bwd(x_, scale, g_, dx_, dscale, dbias, partials,
                                       eps=eps)

            def plain_bwd():
                x_, g_, _, _ = next_set()
                ln.layernorm_backward_reference(x_, scale, g_, eps)

            def library_bwd():
                out, leaves, g_ = graphs[(turn["i"] + 1) % n_sets]
                turn["i"] += 1
                torch.autograd.grad(out, leaves, g_, retain_graph=True)

            runs = {
                "layernorm_fwd": (
                    kernel_fwd,
                    lambda: ln.layernorm_reference(next_set()[0], scale, bias, eps=eps),
                    lambda: F.layer_norm(next_set()[0], (d,), w, b, eps)),
                "layernorm_bwd": (kernel_bwd, plain_bwd, library_bwd),
            }
            for i, (name, (kernel, plain, library)) in enumerate(runs.items()):
                ms, plain_ms, lib_ms = _time_ms(kernel), _time_ms(plain), _time_ms(library)
                least, by = ln_bound_ms(name, dtype, rows, d)
                tag = f"{str(dtype).split('.')[-1]} R={rows} D={d}"
                check = "; ".join(f"eps {k:g}: {v[i]}" for k, v in checks.items())
                print(f"[3 kernels] {name:22s} {tag:24s} err={errs[name]:.3e} "
                      f"({check}; tol {LN_TOL[dtype]:.0e}, sums {LN_SUM_TOL:.0e})  "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                      f"{lib_ms:.4f} ms  bound {least:.4f} ms ({by})  "
                      f"[{n_sets} input sets]", flush=True)
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], errs[name])
                if (dtype, rows, d) == LN_MAIN_CASE:
                    r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=least, bound_by=by, shape=tag)
            del sets, graphs
            torch.cuda.empty_cache()


def _flash_inputs(gen, dtype, b, h, sq, sk, dh, layout, masked):
    """q, k, v [B, H, S, Dh] as the models hand them to `attend`, and the
    [B, 1, 1, Sk] padding mask (batch row 0 fully masked)."""
    def proj(s, parts=1):
        return torch.randn((b, s, parts, h, dh), generator=gen,
                           device="cuda").to(dtype)

    q = proj(sq)[:, :, 0].transpose(1, 2)
    if layout == "packed":
        kv = proj(sk, 2).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    else:
        k, v = (proj(sk)[:, :, 0].transpose(1, 2) for _ in range(2))
    bias = None
    if masked:
        mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
        mask[:, 0] = True
        mask[0] = False
        bias = make_additive_mask(mask.long())
    return q, k, v, bias


def phase_flash(results: dict) -> None:
    """K9 against `flash_attention_reference` at FLASH_CASES; the times of
    FLASH_MAIN_CASE go into `results`."""
    name = "fused_attention_fwd"
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, sq, sk, dh, layout, masked in FLASH_CASES:
            scale = dh ** -0.5
            q, k, v, bias = _flash_inputs(gen, dtype, b, h, sq, sk, dh, layout,
                                          masked)
            flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)
            kernel = lambda: flash.flash_attention(q, k, v, scale=scale, bias=bias)
            got = kernel()
            torch.cuda.synchronize()
            if any(flash.contiguous_copies.values()):
                raise AssertionError(f"{name} {label}: inputs were copied: "
                                     f"{flash.contiguous_copies}")
            ref = flash.flash_attention_reference(
                q.float(), k.float(), v.float(), scale=scale, bias=bias)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {label}: non-finite output")
            err = (got.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            if not rel <= FLASH_TOL[dtype]:
                raise AssertionError(f"{name} {dtype} {label} B={b} Sq={sq} "
                                     f"Sk={sk}: error {rel} of max |reference| "
                                     f"> {FLASH_TOL[dtype]}")
            if masked:  # batch row 0: uniform over its keys
                uniform = v[0].float().mean(dim=-2, keepdim=True)
                uerr = ((got[0].float() - uniform).abs().max()
                        / uniform.abs().max()).item()
                if not uerr <= FLASH_TOL[dtype]:
                    raise AssertionError(f"{name} {label}: a fully masked row "
                                         f"is not uniform: {uerr}")
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            lib_mask = None if bias is None else bias.to(dtype)
            ms, host_ms = _time_with_host_ms(kernel)
            plain_ms = _time_ms(lambda: attend_plain(q, k, v, scale=scale, bias=bias))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=lib_mask, scale=scale))
            least, by = flash_bound_ms(dtype, b, h, sq, sk, dh, masked)
            tag = f"{str(dtype).split('.')[-1]} {label} B={b} Sq={sq} Sk={sk}"
            note = (f"  [the wrapper's host time: {host_ms:.4f} ms a call]"
                    if host_ms >= 0.8 * ms else "")
            print(f"[3 kernels] {name:22s} {tag:36s} err={err:.3e} (rel "
                  f"{rel:.2e}, tol {FLASH_TOL[dtype]:.0e})  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
                  f"{least:.4f} ms ({by}){note}", flush=True)
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if (dtype, label, b, sq) == FLASH_MAIN_CASE:
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=least, bound_by=by, shape=tag)
            del q, k, v, qc, kc, vc, got, ref
            torch.cuda.empty_cache()


_TINY_SETS = [
        "model.video.img_size=64", "model.video.embed_dim=128",
        "model.video.depth=4", "model.video.num_heads=2",
        "model.video.num_frames=4", "model.text.vocab_size=1000",
        "model.text.hidden_size=128", "model.text.num_layers=4",
        "model.text.num_heads=2", "model.text.intermediate_size=256",
        "model.text.max_position_embeddings=40",
        "model.text.hidden_dropout=0.0", "model.text.attn_dropout=0.0",
        "model.fusion.num_fuse_block=2", "model.fusion.dim_video=128",
        "model.fusion.dim_text=128", "model.fusion.hidden_size=128",
        "model.projection_dim=64", "model.remat=false", "path_remat=false",
]


def _tiny_config():
    return load_train_config(None, _TINY_SETS)


def phase_tiny() -> None:
    cfg = _tiny_config()
    cpu_model = random_init_(EgoVLPv2(cfg.model, device="cpu"),
                             torch.Generator().manual_seed(1))
    gpu_model = EgoVLPv2(cfg.model, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    models = (("cpu", cpu_model), ("cuda", gpu_model))

    # inference: the EgoMCQ step
    rng = np.random.default_rng(2)
    video5 = rng.standard_normal((2, 5, 4, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 1000, (2, 15))
    ids[:, 0], ids[0, 9:] = 0, 1  # BOS; padding in item 0
    mask = (ids != 1).astype(np.int64)
    outs = {}
    _reset_counts()
    for dev, model in models:
        o = make_egomcq_eval_step(model.eval())(video5, ids, mask)
        outs[dev] = {k: v.cpu() for k, v in o.items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in ("vtc", "vtm")}
    print(f"[4 tiny] egomcq cuda vs cpu max_abs_err {errs} (tol 1e-3)",
          flush=True)
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"tiny model: cuda and cpu disagree: {errs}")

    # training: one step's losses and gradients, the same mined indices
    batch = synthetic_batch(cfg, 6, np.random.default_rng(3))
    mined = ITMIndices(torch.tensor([0, 3, 2, 5, 4, 1]),
                       torch.tensor([0, 1, 2, 3, 0, 5]),
                       torch.tensor([1, 0, 1, 0, 0, 0]))
    mine = train_step_module.mine_itm_indices
    losses, grads = {}, {}
    try:
        for dev, model in models:
            train_step_module.mine_itm_indices = lambda *a, dev=dev, **k: \
                ITMIndices(*(t.to(dev) for t in mined))
            model.train().zero_grad(set_to_none=True)
            loss, metrics = train_step_module.pretrain_loss_fn(
                model, train_step_module.batch_to_device(batch, torch.device(dev)),
                None, cfg=cfg)
            loss.backward()
            losses[dev] = {k: v.item() for k, v in metrics.items()}
            grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    finally:
        train_step_module.mine_itm_indices = mine
    _compare_tiny_steps("pretrain step", losses, grads)
    launched = dict(_kernels.launch_counts)
    if not all(launched.values()):
        raise AssertionError(f"tiny model on cuda skipped a kernel: {launched}")

    # the dual fine-tune step, without and with one checkpoint region a block
    rng = np.random.default_rng(4)
    dual_batch = {"video": rng.standard_normal((6, 4, 64, 64, 3)).astype(np.float32),
                  "text_ids": rng.integers(3, 1000, (6, 15)),
                  "text_mask": np.ones((6, 15), np.int64)}
    dual_batch["text_ids"][:, 0] = 0
    dual_batch["text_ids"][0, 9:], dual_batch["text_mask"][0, 9:] = 1, 0
    for remat in (False, True):
        dual_cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, projection="small", with_itm_head=False,
                with_mlm_head=False, remat=remat),
            loss=dataclasses.replace(cfg.loss, type="NormSoftmax"))
        cpu_dual = random_init_(EgoVLPv2(dual_cfg.model, device="cpu"),
                                torch.Generator().manual_seed(5))
        gpu_dual = EgoVLPv2(dual_cfg.model, device="cuda")
        gpu_dual.load_state_dict(cpu_dual.state_dict(), strict=True)
        losses, grads = {}, {}
        before = dict(_kernels.launch_counts)
        for dev, model in (("cpu", cpu_dual), ("cuda", gpu_dual)):
            model.train()
            loss, metrics = dual_loss_fn(
                model, train_step_module.batch_to_device(dual_batch, torch.device(dev)),
                cfg=dual_cfg)
            loss.backward()
            losses[dev] = {k: v.item() for k, v in metrics.items()}
            grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None}
        if set(grads["cpu"]) != set(grads["cuda"]):
            raise AssertionError("tiny dual step: other parameters have gradients")
        _compare_tiny_steps(f"dual step, remat {remat}", losses, grads)
        if not all(_kernels.launch_counts[k] > before[k] for k in before):
            raise AssertionError(f"tiny dual step on cuda skipped a kernel: "
                                 f"{before} -> {_kernels.launch_counts}")


def phase_tiny_extract() -> None:
    """The extractors' outputs on the card within 1e-3 of max |cpu output|,
    from one seeded model at 4 frames (MQ, NLQ) and one at 5 (QFVS)."""
    tok = Tokenizer("roberta-base", max_len=15, vocab_cap=1000)
    enc = tok(list(NLQ_QUERIES))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (23, 64, 64, 3), dtype=np.uint8)

    def pair(cfg, seed):
        cpu = random_init_(EgoVLPv2(cfg.model, device="cpu"),
                           torch.Generator().manual_seed(seed))
        gpu = EgoVLPv2(cfg.model, device="cuda")
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        return {"cpu": cpu, "cuda": gpu}

    outs, change_points = {}, {}
    for dev, model in pair(_tiny_config(), 7).items():
        ex = FeatureExtractor(model, inner_batch=4, device_norm="imagenet")
        outs[dev] = {
            "mq features": ex.clip_features(frames, 4),
            "nlq fused features": ex.fused_window_features(
                frames, 4, enc["text_ids"][0], enc["text_mask"][0]),
            "nlq query tokens": ex.text_tokens(enc["text_ids"], enc["text_mask"]),
        }
    qcfg = load_train_config(None, [
        *(s for s in _TINY_SETS if "num_frames" not in s),
        "model.video.num_frames=5"])
    scenes = frames.astype(np.float32) / 255.0
    scenes[10:] *= 0.1  # a cut to a dark scene after two clips: a change point
    for dev, model in pair(qcfg, 8).items():
        res = QFVSExtractor(model, inner_batch=2).extract_video(
            scenes, tok, QFVS_CONCEPTS, QFVS_ORACLE, max_segments=4)
        change_points[dev] = res["change_points"].tolist()
        outs[dev].update({f"qfvs features '{k}'": v
                          for k, v in res["features"].items()})
    errs = {}
    for key, ref in outs["cpu"].items():
        got = outs["cuda"][key]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"tiny extract: {key}: bad output on cuda")
        errs[key] = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    print(f"[4 tiny] extract cuda vs cpu, error of max |cpu output| "
          f"{ {k: f'{e:.2e}' for k, e in errs.items()} } (tol 1e-3); qfvs "
          f"change points {change_points}; K9 inputs copied "
          f"{flash.contiguous_copies}", flush=True)
    if not all(e <= 1e-3 for e in errs.values()) or not change_points["cpu"] \
            or change_points["cuda"] != change_points["cpu"]:
        raise AssertionError(f"tiny extract: cuda and cpu disagree: {errs}, "
                             f"{change_points}")


def _compare_tiny_steps(what: str, losses: dict, grads: dict) -> None:
    """cuda against cpu: loss parts within 1e-3, every gradient within 1e-3
    of max |cpu gradient| of its tensor."""
    loss_err = max(abs(losses["cuda"][k] - losses["cpu"][k]) for k in losses["cpu"])
    worst, worst_name = 0.0, ""
    for name, ref in grads["cpu"].items():
        rel = ((grads["cuda"][name] - ref).abs().max()
               / ref.abs().max().clamp_min(1e-6)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[4 tiny] {what} cuda vs cpu: losses {losses['cuda']} max_abs_err "
          f"{loss_err:.2e} (tol 1e-3); {len(grads['cpu'])} parameter gradients, "
          f"worst {worst:.2e} of max |cpu gradient| at {worst_name} (tol 1e-3); "
          f"launches so far {dict(_kernels.launch_counts)}", flush=True)
    if not (loss_err <= 1e-3 and worst <= 1e-3):
        raise AssertionError(f"tiny model, {what}: cuda and cpu disagree")


def _no_flash_copies(path: str) -> None:
    if any(flash.contiguous_copies.values()):
        raise AssertionError(f"{path}: K9 inputs were copied to make them "
                             f"readable by stride: {flash.contiguous_copies}")


def phase_egomcq() -> dict:
    """Returns path -> the launch counts of that path's own run."""
    base = ["egomcq", "--config", "configs/eval_egomcq.json", "--device",
            "cuda", "--val_batches", "2"]
    by_path = {}
    for label, extra in (("16f", []), ("4f", ["--set",
                                              "model.video.num_frames=4"])):
        _reset_counts()
        res = cli.main(base + extra)
        counts = dict(_kernels.launch_counts)
        scores = res["scores"]
        finite = all(np.isfinite(v).all() for v in scores.values())
        steps_ms = [round(x * 1e3, 1) for x in res["step_seconds"]]
        step_s = res["step_seconds"][-1]  # the first step carries warm-up
        shapes = {k: v.shape for k, v in scores.items()}
        print(f"[5 slices] egomcq {label}: metrics {res['metrics']} | step "
              f"{step_s * 1e3:.1f} ms (one sample: the last of steps "
              f"{steps_ms} ms, input copy included) | "
              f"{res['clips_per_step'] / step_s:.2f} clips/s | scores "
              f"{shapes} finite={finite} | launches {counts} | LayerNorm inputs "
              f"copied to make them contiguous {ln.contiguous_copies}, K9 "
              f"inputs {flash.contiguous_copies}", flush=True)
        _no_flash_copies(f"egomcq {label}")
        if not finite or set(scores) != {"vtc", "vtm"}:
            raise AssertionError(f"egomcq {label}: bad scores {scores}")
        if not all(counts[k] for k in counts if k.endswith("_fwd")):
            raise AssertionError(f"egomcq {label}: a kernel was not launched: "
                                 f"{counts}")
        by_path[f"egomcq_{label}"] = counts
        del res
        _free()
    return by_path


def phase_pretrain() -> dict:
    args = ["pretrain", "--synthetic", "--device", "cuda", "--steps_per_epoch",
            str(PRETRAIN_STEPS), "--set", *PRETRAIN_SETS]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = cli.main(args)
    counts = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    rows = res["logged"]
    if len(rows) != PRETRAIN_STEPS:
        raise AssertionError(f"pretrain logged {len(rows)} steps")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"pretrain: non-finite loss part in {row}")
    per_step = {k: v / PRETRAIN_STEPS for k, v in counts.items()}
    if not all(v >= 1 and v == int(v) for v in per_step.values()):
        raise AssertionError(f"pretrain: launches a step {per_step}")
    cfg = load_train_config(None, PRETRAIN_SETS)
    fresh = training_init_(EgoVLPv2(cfg.model, device="cpu"),
                           torch.Generator().manual_seed(cfg.seed))
    moved = sum(not torch.equal(p.detach().cpu(), q.detach())
                for p, q in zip(res["model"].parameters(), fresh.parameters()))
    n_params = sum(1 for _ in fresh.parameters())
    steps_ms = [s * 1e3 for s in res["step_seconds"]]
    warm = float(np.median(steps_ms[2:]))  # the first two carry warm-up
    print(f"[5 slices] pretrain b16 4f bf16: {PRETRAIN_STEPS} steps, last "
          f"{rows[-1]} | step ms {[round(x, 1) for x in steps_ms]}, median of "
          f"the last {PRETRAIN_STEPS - 2} {warm:.1f} ms = "
          f"{res['clips_per_step'] / warm * 1e3:.2f} clips/s | launches a "
          f"step {per_step} | LayerNorm inputs copied to make them contiguous "
          f"{ln.contiguous_copies}, K9 inputs {flash.contiguous_copies} | "
          f"parameters changed {moved}/{n_params} | "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    _no_flash_copies("pretrain")
    if moved < n_params // 2:
        raise AssertionError(f"pretrain: only {moved}/{n_params} parameters "
                             "changed")
    del res
    _free()
    return counts


def phase_finetune() -> dict:
    """The 32-frame Charades-Ego fine-tune through `cli ft-charades`, first
    without rematerialisation, then with one checkpoint region a block.
    Returns run -> the launch counts of that run."""
    by_run = {}
    for label, remat_set, steps in FINETUNE_RUNS:
        args = ["ft-charades", "--synthetic", "--device", "cuda", "--config",
                FINETUNE_CONFIG, "--steps_per_epoch", str(steps), "--set",
                *FINETUNE_SETS, remat_set]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = cli.main(args)
        counts = dict(_kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        rows, cfg = res["logged"], res["config"]
        if len(rows) != steps:
            raise AssertionError(f"{label} logged {len(rows)} steps")
        if not all(np.isfinite(row["loss_total"]) for row in rows):
            raise AssertionError(f"{label}: non-finite loss in {rows}")
        per_step = {k: v / steps for k, v in counts.items()}
        if not all(per_step[k] >= 1 and per_step[k] == int(per_step[k])
                   for k in FINETUNE_KERNELS):
            raise AssertionError(f"{label}: launches a step {per_step}")
        fresh = training_init_(EgoVLPv2(cfg.model, device="cpu"),
                               torch.Generator().manual_seed(cfg.seed))
        moved = sum(not torch.equal(p.detach().cpu(), q.detach())
                    for p, q in zip(res["model"].parameters(), fresh.parameters()))
        n_params = sum(1 for _ in fresh.parameters())
        steps_ms = [s * 1e3 for s in res["step_seconds"]]
        warm = float(np.median(steps_ms[2:])) if steps > 2 else steps_ms[-1]
        v = cfg.model.video
        print(f"[5 slices] {label} b{cfg.global_batch_size} {v.num_frames}f "
              f"S={v.seq_len} {cfg.model.compute_dtype} {remat_set}: {steps} "
              f"steps, losses {[round(r['loss_total'], 4) for r in rows]} | step "
              f"ms {[round(x, 1) for x in steps_ms]}, "
              f"{'median of the last ' + str(steps - 2) if steps > 2 else 'the last'}"
              f" {warm:.1f} ms = {res['clips_per_step'] / warm * 1e3:.2f} "
              f"clips/s | launches a step {per_step} | LayerNorm inputs copied "
              f"to make them contiguous {ln.contiguous_copies} | parameters "
              f"changed {moved}/{n_params} | peak memory {peak / 2**30:.2f} GiB",
              flush=True)
        if moved < n_params // 2:
            raise AssertionError(f"{label}: only {moved}/{n_params} parameters "
                                 "changed")
        by_run[label] = counts
        del res, fresh
        _free()
    return by_run


def _batch_ms(log) -> str:
    ms = [m for _, m in log]
    return (f"inner batches {log[0][0]} ms {[round(m, 1) for m in ms]}, "
            f"{sum(ms):.1f} ms in all")


def _check_extract(path: str, counts: dict, fused: bool) -> None:
    need = ["space_attention_fwd", "time_attention_fwd",
            "cls_row_attention_fwd", "layernorm_fwd"]
    if fused:
        need.append("fused_attention_fwd")
    if not all(counts[k] for k in need):
        raise AssertionError(f"{path}: a kernel was not launched: {counts}")
    _no_flash_copies(path)


def phase_extract() -> dict:
    """The three feature-extraction paths at full width, bf16. Returns path
    -> the launch counts of that path's own run."""
    by_path = {}
    cfg = load_train_config(EXTRACT_CONFIG, [])
    v = cfg.model.video
    with tempfile.TemporaryDirectory() as out:
        # MQ: the dual video tower through `cli extract`
        _reset_counts()
        res = cli.main(["extract", "--config", EXTRACT_CONFIG, "--device",
                        "cuda", "--synthetic", str(EXTRACT_FRAMES), "--out", out])
        counts = dict(_kernels.launch_counts)
        feats = res["features"]["synthetic"]
        n_win = EXTRACT_FRAMES // v.num_frames
        ok = feats.shape == (n_win, cfg.model.projection_dim) \
            and np.isfinite(feats).all() and feats.std() > 0 \
            and np.array_equal(np.load(os.path.join(out, "synthetic.npy")), feats)
        print(f"[5 slices] extract mq {v.num_frames}f S={v.seq_len} "
              f"{cfg.model.compute_dtype}: {EXTRACT_FRAMES} uint8 frames -> "
              f"features {feats.shape} ok={ok} | "
              f"{_batch_ms(res['inner_batches'])} | launches {counts}",
              flush=True)
        if not ok or len(res["inner_batches"]) != 2:
            raise AssertionError("extract mq: bad features or inner batches")
        _check_extract("extract mq", counts, fused=False)
        by_path["extract_mq"] = counts

        # NLQ: the fused stack, two queries over the same frames
        model = res["model"]
        frames = np.random.default_rng(cfg.seed).integers(
            0, 256, (EXTRACT_FRAMES, v.img_size, v.img_size, v.in_chans),
            dtype=np.uint8)
        tok = Tokenizer("roberta-base", max_len=cfg.max_text_len,
                        vocab_cap=cfg.model.text.vocab_size)
        records = [{"clip_uid": "synthetic", "annotation_uid": "a0",
                    "query_idx": i, "query": q}
                   for i, q in enumerate(NLQ_QUERIES)]
        ex = FeatureExtractor(model, inner_batch=64, device_norm="imagenet")
        _reset_counts()
        n_windows = extract_nlq_features(ex, tok, records, lambda uid: frames,
                                         v.num_frames, out)
        counts = dict(_kernels.launch_counts)
        shapes = {}
        for i in range(len(NLQ_QUERIES)):
            for suffix, shape in (("", (n_win, v.embed_dim)),
                                  ("_query", (cfg.max_text_len,
                                              cfg.model.text.hidden_size))):
                arr = np.load(os.path.join(out, f"synthetic_a0_{i}{suffix}.npy"))
                shapes[f"q{i}{suffix}"] = arr.shape
                if arr.shape != shape or not np.isfinite(arr).all() \
                        or not arr.std() > 0:
                    raise AssertionError(f"extract nlq: bad output q{i}{suffix}"
                                         f" {arr.shape}")
        q0 = np.load(os.path.join(out, "synthetic_a0_0.npy"))
        q1 = np.load(os.path.join(out, "synthetic_a0_1.npy"))
        if n_windows != {"synthetic": n_win} or np.array_equal(q0, q1):
            raise AssertionError("extract nlq: the query does not reach the "
                                 "fused features")
        print(f"[5 slices] extract nlq: {len(NLQ_QUERIES)} queries x {n_win} "
              f"windows -> {shapes} | {_batch_ms(ex.batch_log)} | launches "
              f"{counts} | K9 inputs copied {flash.contiguous_copies}",
              flush=True)
        _check_extract("extract nlq", counts, fused=True)
        by_path["extract_nlq"] = counts
        del res, model, ex, frames
        _free()

    # QFVS: 5 frames a clip, the unfused tower, KTS, the fused blocks a prompt
    qcfg = load_train_config(EXTRACT_CONFIG, ["model.video.num_frames=5"])
    model = EgoVLPv2(qcfg.model, device="cuda").eval()
    random_init_(model, torch.Generator().manual_seed(qcfg.seed))
    frames = np.random.default_rng(qcfg.seed).integers(
        0, 256, (QFVS_FRAMES, v.img_size, v.img_size, v.in_chans), dtype=np.uint8)
    ex = QFVSExtractor(model, inner_batch=QFVS_INNER_BATCH)
    _reset_counts()
    t0 = time.perf_counter()
    res = ex.extract_video(frames, tok, QFVS_CONCEPTS, QFVS_ORACLE)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(_kernels.launch_counts)
    n_clips = QFVS_FRAMES // 5
    hs = qcfg.model.fusion.hidden_size
    feats = res["features"]
    ok = res["num_shots"] == n_clips \
        and list(feats) == [*QFVS_CONCEPTS, QFVS_ORACLE] \
        and all(f.shape == (n_clips, hs) and np.isfinite(f).all()
                and f.std() > 0 for f in feats.values()) \
        and not np.array_equal(feats[QFVS_CONCEPTS[0]], feats[QFVS_CONCEPTS[1]])
    print(f"[5 slices] extract qfvs 5f S={qcfg.model.video.seq_len}: "
          f"{QFVS_FRAMES} uint8 frames -> {n_clips} clips, change points "
          f"{res['change_points'].tolist()}, features "
          f"{ {k: f.shape for k, f in feats.items()} } ok={ok} | "
          f"{total_ms:.1f} ms in all; {_batch_ms(ex.batch_log)} | launches "
          f"{counts} | K9 inputs copied {flash.contiguous_copies}", flush=True)
    if not ok:
        raise AssertionError("extract qfvs: bad output")
    _check_extract("extract qfvs", counts, fused=True)
    by_path["extract_qfvs"] = counts
    del res, model, ex
    _free()
    return by_path


def main() -> None:
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    phase_tiny()
    phase_tiny_extract()
    by_path = phase_egomcq()
    by_path["pretrain"] = phase_pretrain()
    by_path.update(phase_finetune())
    by_path.update(phase_extract())
    for path in ("egomcq_16f", "egomcq_4f", "pretrain"):
        if not by_path[path]["fused_attention_fwd"]:
            raise AssertionError(f"{path}: K9 was not launched")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "egovlpv2_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    # `launches` is the pretrain run's own count (it runs all nine kernels);
    # each path's count stands beside it, never summed.
    # One launch of a grouped attention backward wrapper is two __global__
    # launches (a query pass, then a key pass), one of the LayerNorm
    # backward two as well (the rows, then the sum of the blocks' partials).
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": by_path["pretrain"][k],
         "launches_a_pretrain_step": by_path["pretrain"][k] // PRETRAIN_STEPS,
         "launches_by_path": {path: c[k] for path, c in by_path.items()},
         **results[k]}
        for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
