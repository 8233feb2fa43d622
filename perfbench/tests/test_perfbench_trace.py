"""The trace's links and the per-layer readers on a synthetic profile: a
kernel belongs to the range its launch lies in, an op's backward to the
autograd node with the sequence number its forward recorded."""

from pathlib import Path
from types import SimpleNamespace as Context

import pytest

from perfbench import bounds, kinds, manifest, trace

ROOT = Path(__file__).resolve().parents[2]
CALL = trace.call_name("divided_attn", b=2, s=9, h=1, dh=8, frames=2,
                       axis="space", dtype="bfloat16")


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    X("user_annotation", trace.STRETCH, 0, 1000),
    X("user_annotation", CALL, 10, 20),
    X("cpu_op", "_DividedAttentionKernels", 12, 10, **{"Sequence number": 5}),
    X("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=100),
    X("kernel", "space_fwd_frame_kernel", 50, 30, correlation=100),
    X("cpu_op", "autograd::engine::evaluate_function: "
      "_DividedAttentionKernelsBackward", 300, 50, tid=2,
      **{"Sequence number": 5}),
    X("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=2, correlation=101),
    X("kernel", "space_bwd_frame_kernel", 400, 60, correlation=101),
    X("cpu_op", "aten::mm", 100, 10),
    X("cuda_runtime", "cudaLaunchKernel", 105, 2, correlation=102),
    X("kernel", "nvjet_gemm", 150, 100, correlation=102),
    X("user_annotation", "Optimizer.step#AdamW.step", 600, 100),
    X("cuda_runtime", "cudaLaunchKernel", 610, 2, correlation=103),
    X("kernel", "multi_tensor_apply_kernel", 650, 200, correlation=103),
    X("cpu_op", "aten::item", 860, 130),
]


@pytest.fixture
def ctx():
    # the device-only stretch holds the same device events, 1 ms of host
    device = [e for e in EVENTS if e["cat"] == "kernel"]
    return Context(trace=trace.Trace(EVENTS), stretch_steps=2,
                   timeline=trace.Trace(device), timeline_s=1e-3)


def read(name, ctx):
    return manifest.reader(ROOT, name).read(ctx)


def test_links(ctx):
    tr = ctx.trace
    call = tr.named("perfbench.divided_attn|")[0]
    assert tr.corr_under(call) == [100]
    assert [n.seq for n in tr.backward_of(call)] == [5]
    assert tr.busy_us() == 390


def test_readers(ctx):
    assert read("gemm_ms_per_step.train", ctx) == pytest.approx(0.05)
    assert read("optimizer_ms_per_step.train", ctx) == pytest.approx(0.1)
    assert read("device_idle_share.train", ctx) == pytest.approx(61.0)
    fwd = bounds.least_seconds(*bounds.divided_attention(
        2, 9, 1, 8, 2, "space", "bfloat16", False), "bfloat16", True)
    bwd = bounds.least_seconds(*bounds.divided_attention(
        2, 9, 1, 8, 2, "space", "bfloat16", True), "bfloat16", True)
    assert read("divided_attn_roofline.train", ctx) == pytest.approx(
        100 * (fwd + bwd) / 90e-6)
    assert read("layernorm_roofline.train", ctx) is None


def test_breakdown(ctx):
    b = kinds.breakdown(ctx.timeline, ctx.trace)
    assert b["device_ops"][0] == ["optimizer (AdamW, foreach)", 200e-6]
    assert dict(b["device_ops"])["GEMM (cuBLAS)"] == pytest.approx(100e-6)
    assert b["idle_gaps"][0] == ["Optimizer.step#AdamW.step",
                                 pytest.approx(190e-6)]
    assert ["aten::item", pytest.approx(150e-6)] in b["idle_gaps"]


def test_readers_find_nothing_without_a_trace():
    empty = Context(trace=None, stretch_steps=0, timeline=None,
                    timeline_s=0.0)
    for name in ("gemm_ms_per_step.train", "optimizer_ms_per_step.train",
                 "device_idle_share.train", "divided_attn_roofline.train",
                 "layernorm_roofline.train"):
        assert read(name, empty) is None
