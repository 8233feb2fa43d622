"""On the card, at the cells' own sizes: the float8 control put in the
program's place comes out not correct; the kernel families that the
per-layer readers time read alike from eager launches and from a replayed
CUDA graph. Skips without a card."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pretrain_4f_b64"])
def test_control_fails_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import calibrate, compare, harness

    c = harness.Cell(ROOT, cell)
    got = calibrate.readings(c, 2 ** 31 + 3, "cuda", "control")
    numbers = {k: got[k] for k in c.spec["limits"]}
    assert not compare.judge(numbers, c.spec["limits"])


@pytest.mark.gpu
def test_graph_replay_reads_as_eager_launches(tmp_path):
    """K7 forward and backward, one bf16 GEMM and K1's forward (with K3's
    CLS row) at the pretrain cell's shapes, launched eagerly and then
    replayed from a CUDA graph, each under `trace.profile_device`: each
    kernel family's device time agrees within 5% and has as many kernels.
    In a host-and-device trace of three replays, each a step, every
    replayed kernel carries its cudaGraphLaunch's correlation, so each step
    counts one launch."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from egovlpv2_torch.ops import _kernels
    from egovlpv2_torch.ops.divided import divided_attention
    from perfbench import kinds, program_spans, trace

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2 ** 31 + 17)
    b, f, n, h, dh = 64, 4, 196, 12, 64
    s, d = 1 + f * n, h * dh
    rows = b * s

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    x, g, a, qkv = (normal(rows, d), normal(rows, d), normal(rows, d),
                    normal(b, s, 3, h, dh))
    w = normal(d, 3 * d)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    bias = torch.randn(d, generator=gen, device=dev)
    y, dx, c = torch.empty_like(x), torch.empty_like(x), normal(rows, 3 * d)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partials = _kernels.layernorm_bwd_scratch(x)

    def chain():
        _kernels.layernorm_fwd(x, scale, bias, y, eps=1e-5)
        _kernels.layernorm_bwd(x, scale, g, dx, dscale, dbias, partials,
                               eps=1e-5)
        torch.matmul(a, w, out=c)
        divided_attention(qkv, scale=dh ** -0.5, axis="space", num_frames=f)

    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                chain()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            chain()
        reps = 20
        eager, _ = trace.profile_device(lambda: [chain() for _ in range(reps)])
        replay, _ = trace.profile_device(
            lambda: [graph.replay() for _ in range(reps)])

    def count(tr, family):
        return sum(kinds.kind(e[2]) in kinds.FAMILIES[family]
                   for e in tr.device)

    for family in ("layernorm", "gemm", "divided_attn"):
        e, r = (kinds.family_seconds(eager, family),
                kinds.family_seconds(replay, family))
        print(f"{family}: eager {e!r} s, replay {r!r} s, kernels "
              f"{count(eager, family)} / {count(replay, family)}")
        assert e is not None and r is not None
        assert count(replay, family) == count(eager, family) >= reps
        assert r == pytest.approx(e, rel=0.05)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.STRETCH):
            for _ in range(3):
                with torch.profiler.record_function(program_spans.STEP):
                    graph.replay()
            torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    graph_launches = {e["args"]["correlation"] for e in events
                      if e.get("name") == "cudaGraphLaunch"
                      and "correlation" in (e.get("args") or {})}
    tr = trace.load_chrome(str(path))
    kernels = [ev for ev in tr.device if kinds.kind(ev[2]) in
               kinds.FAMILIES["layernorm"] + kinds.FAMILIES["gemm"]
               + kinds.FAMILIES["divided_attn"]]
    print(f"replays: {len(graph_launches)} cudaGraphLaunch, "
          f"{len(kernels)} family kernels, launches a step "
          f"{program_spans.launches_per_step(tr)}")
    assert len(graph_launches) == 3
    assert kernels and all(ev[3] in graph_launches for ev in kernels)
    assert program_spans.launches_per_step(tr) == [1, 1, 1]
