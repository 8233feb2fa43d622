"""Device operations by kind, from their names (`KINDS`, first match wins,
copied from `scripts/profile_torch_pretrain.py`, with NCCL's kernels as a
kind of their own), and the traced run's
`breakdown`: the kinds that took most device time and the longest idle
gaps, each gap named by the host range that overlaps it most."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

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
        "general_fwd_", "general_bwd_")),
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
    ("NCCL", ("nccl",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "gemv")),
    ("optimizer (AdamW, foreach)", ("multi_tensor", "adam")),
    ("reductions", ("reduce_kernel",)),
)
OTHER = "elementwise and copies"


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
