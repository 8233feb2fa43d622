"""The trace's links and the per-layer readers on a synthetic profile: an
op's backward is the autograd node with the sequence number its forward
recorded; a kernel family's time is read by kernel name, so a step that
replays a CUDA graph reads as the same kernels launched one by one."""

from pathlib import Path
from types import SimpleNamespace as Context

import pytest

from perfbench import bounds, kinds, manifest, program_spans, trace

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (("b", 2), ("s", 9), ("h", 1), ("dh", 8), ("frames", 2),
         ("axis", "space"), ("dtype", "bfloat16"))
CALL = trace.call_name("divided_attn", **dict(SHAPE))
LN_SHAPE = (("rows", 18), ("d", 8), ("dtype", "bfloat16"))
K9_SHAPE = (("b", 2), ("h", 1), ("sq", 9), ("sk", 4), ("dh", 8),
            ("dtype", "bfloat16"), ("causal", False), ("bias", True))
CALLS = [bounds.Call("divided_attn", SHAPE, True)]
FAMILY_READERS = ("gemm_ms_per_step.train", "optimizer_ms_per_step.train",
                  "divided_attn_roofline.train", "layernorm_roofline.train",
                  "fused_attn_roofline.train")


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
    return Context(trace=trace.Trace(EVENTS), stretch_steps=2, calls=CALLS,
                   timeline=trace.Trace(device), timeline_s=1e-3)


def read(name, ctx):
    return manifest.reader(ROOT, name).read(ctx)


def test_links(ctx):
    tr = ctx.trace
    call = tr.named("perfbench.divided_attn|")[0]
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
    # one call a step, two steps, over K1's and K4's 90 us
    assert read("divided_attn_roofline.train", ctx) == pytest.approx(
        100 * 2 * (fwd + bwd) / 90e-6)
    assert read("layernorm_roofline.train", ctx) is None


def test_breakdown(ctx):
    b = kinds.breakdown(ctx.timeline, ctx.trace)
    assert b["device_ops"][0] == ["optimizer (AdamW)", 200e-6]
    assert dict(b["device_ops"])["GEMM (cuBLAS)"] == pytest.approx(100e-6)
    assert b["idle_gaps"][0] == ["Optimizer.step#AdamW.step",
                                 pytest.approx(190e-6)]
    assert ["aten::item", pytest.approx(150e-6)] in b["idle_gaps"]


def test_readers_find_nothing_without_a_trace():
    empty = Context(trace=None, stretch_steps=0, timeline=None,
                    timeline_s=0.0, calls=CALLS)
    for name in FAMILY_READERS + ("device_idle_share.train",):
        assert read(name, empty) is None


# one step's kernels: (name, start us, duration us, the host range they are
# launched from eagerly); K4's copy of its cotangent and the cast inside
# aten::mm run under the ops' ranges but are no kernels of their families
STEP_KERNELS = [
    ("space_fwd_frame_kernel", 20, 30, CALL),
    ("cls_row_part_kernel", 50, 5, CALL),
    ("layernorm_fwd_kernel", 60, 8, "perfbench.layernorm|rows=18|d=8"
     "|dtype=bfloat16"),
    ("elementwise_kernel<cast>", 70, 6, "aten::mm"),
    ("nvjet_hsh_gemm", 76, 100, "aten::mm"),
    ("elementwise_kernel<copy>", 200, 7,
     "autograd::engine::evaluate_function: _DividedAttentionKernelsBackward"),
    ("space_bwd_frame_kernel", 207, 60,
     "autograd::engine::evaluate_function: _DividedAttentionKernelsBackward"),
    ("layernorm_bwd_kernel", 270, 12,
     "autograd::engine::evaluate_function: _LayerNormBackward"),
    ("layernorm_bwd_sum_kernel", 282, 3,
     "autograd::engine::evaluate_function: _LayerNormBackward"),
    ("void (anonymous namespace)::mma::fused_ring_kernel<64, 1>", 290, 4,
     "perfbench.fused_attn|b=2|h=1|sq=9|sk=4|dh=8|dtype=bfloat16"
     "|causal=False|bias=True"),
    ("multi_tensor_apply_kernel", 300, 40, "Optimizer.step#AdamW.step"),
    (f"void at::native::{kinds.ADAMW_BIAS_CORRECTION}(...)".replace(
        "binaryfunctor", "BinaryFunctor").replace("divfunctor", "DivFunctor"),
     340, 6, "Optimizer.step#AdamW.step"),
]


def step_events(graph: bool):
    """One `egovlpv2.step`: eagerly, each kernel launched under its op's
    range; replayed, one cudaGraphLaunch whose correlation every kernel
    carries and no op range."""
    events = [X("user_annotation", trace.STRETCH, 0, 1000),
              X("user_annotation", program_spans.STEP, 1, 400)]
    if graph:
        events.append(X("cuda_runtime", "cudaGraphLaunch", 5, 10,
                        correlation=500))
    for i, (name, ts, dur, host) in enumerate(STEP_KERNELS):
        corr = 500 if graph else 100 + i
        if not graph:
            at = ts - 10
            events.append(X("cpu_op", host, at - 1, 5))
            events.append(X("cuda_runtime", "cudaLaunchKernel", at, 2,
                            correlation=corr))
        events.append(X("kernel", name, ts, dur, correlation=corr))
    return events


def step_context(graph: bool):
    events = step_events(graph)
    return Context(trace=trace.Trace(events), stretch_steps=1,
                   calls=CALLS + [bounds.Call("layernorm", LN_SHAPE, True),
                                  bounds.Call("fused_attn", K9_SHAPE, True)],
                   timeline=trace.Trace([e for e in events
                                         if e["cat"] == "kernel"]),
                   timeline_s=1e-3)


def test_readers_read_a_graph_replay_as_its_eager_launches():
    eager, graph = step_context(False), step_context(True)
    for name in FAMILY_READERS:
        assert read(name, graph) == pytest.approx(read(name, eager)), name
    assert read("gemm_ms_per_step.train", graph) == pytest.approx(0.1)
    # AdamW's foreach kernels and its bias corrections
    assert read("optimizer_ms_per_step.train", graph) == pytest.approx(0.046)
    least = bounds.least_seconds_of(graph.calls, "layernorm")
    assert read("layernorm_roofline.train", graph) == pytest.approx(
        100 * least / 23e-6)
    # the copy and the cast inside the ops' ranges are not counted
    least = bounds.least_seconds_of(graph.calls, "divided_attn")
    assert read("divided_attn_roofline.train", graph) == pytest.approx(
        100 * least / 95e-6)
    # K9's forward alone, whether or not its call takes a backward
    least = bounds.call_seconds(bounds.Call("fused_attn", K9_SHAPE, False))
    assert least == bounds.least_seconds_of(graph.calls, "fused_attn")
    assert read("fused_attn_roofline.train", graph) == pytest.approx(
        100 * least / 4e-6)
    # a replay is one launch; its kernels all carry its correlation
    assert read("launches_per_step.train", eager) == len(STEP_KERNELS)
    assert read("launches_per_step.train", graph) == 1


def test_family_is_none_without_its_kernels():
    tl = trace.Trace([X("kernel", "nvjet_gemm", 0, 10)])
    assert kinds.family_seconds(tl, "gemm") == pytest.approx(10e-6)
    for family in ("divided_attn", "layernorm", "fused_attn", "adamw"):
        assert kinds.family_seconds(tl, family) is None


@pytest.mark.parametrize("name,family", [
    ("void space_fwd_frame_kernel<64>(...)", "divided_attn"),
    ("time_fwd_tc_kernel", "divided_attn"),
    ("cls_row_merge_kernel", "divided_attn"),
    ("grouped_bwd_key_kernel", "divided_attn"),
    ("general_bwd_merge_kernel", "divided_attn"),
    ("layernorm_bwd_sum_kernel", "layernorm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "gemm"),
    ("void at::native::reduce_kernel<512, 1>", None),
    ("void at::native::multi_tensor_apply_kernel<...>", "adamw"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::DivFunctor<float> > >(at::"
     "TensorIteratorBase&, ...)", "adamw"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "DivFunctor<float> >, std::array<char*, 3ul> >(...)", None),
    ("void (anonymous namespace)::mma::fused_ring_kernel<64, 1>(...)",
     "fused_attn"),
    ("fused_split_kernel", "fused_attn"),
    ("void at::native::elementwise_kernel<128, 4, ...>", None),
])
def test_kernel_families_by_name(name, family):
    got = [f for f, labels in kinds.FAMILIES.items()
           if kinds.kind(name) in labels]
    assert got == ([family] if family else [])
