"""Device operations by kind, from their names (`KINDS`, first match wins,
copied from `scripts/profile_torch_pretrain.py`, with NCCL's kernels as a
kind of their own), the kernel families the per-layer readers time
(`FAMILIES`, unions of kinds), and the traced run's `breakdown`: the kinds
that took most device time and the longest idle gaps, each gap named by
the host range that overlaps it most.

A kernel is put to its kind by its name alone, so a kernel reads the same
whether the host launched it under an operator or a CUDA graph replayed
it. The hand kernels' names are the `__global__` functions of
`egovlpv2_torch/csrc/`."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

K9_KERNELS = ("fused_ring_kernel", "fused_fwd_kernel",
              "fused_tf32_fwd_kernel", "fused_split_kernel",
              "fused_tf32_split_kernel", "fused_merge_kernel")

DIVIDED_FWD = "hand kernels, forward (K1/K2/K3)"
DIVIDED_GENERAL = "hand kernels, general divided attention (K10/K11)"
DIVIDED_BWD = "hand kernels, backward (K4/K5/K6)"
LAYERNORM = "hand kernels, LayerNorm (K7/K8)"
FUSED = "hand kernel, fused attention (K9)"
GEMM = "GEMM (cuBLAS)"
ADAMW = "optimizer (AdamW)"
# `capturable` AdamW divides each parameter's denominator by its 0-d bias
# corrections one parameter at a time (`torch._foreach_div_` over a list of
# 0-d tensors takes its per-tensor path): a float32 division with a
# broadcast operand, two launches a parameter (1,090 of the pretrain
# step's 1,104 such launches, 4.436 of its 4.445 ms; H100, torch 2.11)
ADAMW_BIAS_CORRECTION = (
    "elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
    "at::native::binaryfunctor<float, float, float, "
    "at::native::binary_internal::divfunctor<float> > >")

KINDS = (  # first match wins
    ("memcpy", ("memcpy",)),
    (DIVIDED_FWD, ("space_fwd_kernel", "time_fwd_kernel",
                   "space_fwd_frame_kernel", "time_fwd_tc_kernel",
                   "cls_row_part_kernel", "cls_row_merge_kernel")),
    (DIVIDED_GENERAL, ("general_fwd_kernel", "general_fwd_merge_kernel",
                       "general_bwd_query_kernel", "general_bwd_key_kernel",
                       "general_bwd_merge_kernel")),
    (DIVIDED_BWD, ("grouped_bwd_query_kernel", "grouped_bwd_key_kernel",
                   "space_bwd_frame_kernel", "time_bwd_kernel",
                   "cls_row_bwd_part_kernel", "cls_row_bwd_merge_kernel")),
    (LAYERNORM, ("layernorm_fwd_kernel", "layernorm_bwd_kernel",
                 "layernorm_bwd_sum_kernel")),
    (FUSED, K9_KERNELS),
    ("NCCL", ("nccl",)),
    # cuBLASLt's split-K reduction (`cublasLt::splitKreduce_kernel`) is a
    # GEMM's own second pass
    (GEMM, ("gemm", "nvjet", "cutlass", "xmma", "gemv", "cublas")),
    (ADAMW, ("multi_tensor", "adam", ADAMW_BIAS_CORRECTION)),
    ("reductions", ("reduce_kernel",)),
)
OTHER = "elementwise and copies"

# the kernels that do one layer's work, as the per-layer readers time it:
# the divided attention in bf16 (K1-K6) and in f32 (K10/K11), LayerNorm's
# forward and backward, the fused attention's forward (K9), cuBLAS's
# products, AdamW's foreach updates and bias corrections
FAMILIES = {
    "divided_attn": (DIVIDED_FWD, DIVIDED_GENERAL, DIVIDED_BWD),
    "layernorm": (LAYERNORM,),
    "fused_attn": (FUSED,),
    "gemm": (GEMM,),
    "adamw": (ADAMW,),
}


def kind(name: str) -> str:
    low = name.lower()
    for label, marks in KINDS:
        if any(m in low for m in marks):
            return label
    return OTHER


def device_seconds_by_kind(tr) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for ts, end, name, _ in tr.device:
        out[kind(name)] += (end - ts) / 1e6
    return dict(out)


def family_seconds(tr, family: str) -> Optional[float]:
    """Device seconds of the kernels of `family` in the trace `tr`, or None
    where it holds none."""
    labels = FAMILIES[family]
    found = [end - ts for ts, end, name, _ in tr.device
             if kind(name) in labels]
    return sum(found) / 1e6 if found else None


def breakdown(timeline, linked, top: int = 10) -> Dict[str, List[list]]:
    """Device seconds by kind from the device-only stretch `timeline`;
    the longest idle gaps of the host-and-device stretch `linked`, which
    its tracing of the host lengthens."""
    ops = sorted(device_seconds_by_kind(timeline).items(),
                 key=lambda kv: -kv[1])
    tr = linked
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[tr.open_during(a, b), (b - a) / 1e6]
                          for a, b in gaps]}
