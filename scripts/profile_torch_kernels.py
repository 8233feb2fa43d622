"""Device time a call of the divided-attention kernels (K1, K2, K3 forward;
K4 and K6 after it backward) and of the LayerNorm forward and backward (K7,
K8) at the shapes of `chip_smoke.py`'s phase 3, on one CUDA card.

    python3 scripts/profile_torch_kernels.py [--calls 20] [--only attention]

H=12, Dh=64, bf16. Forward at (B, frames) = (20, 4), (20, 16), (16, 4),
(8, 32), (64, 16), (16, 5) and (8, 4) (S = 1 + 196 frames): K1, K2 and K3
through their wrappers, each on one qkv: the mean device time a call from
torch.profiler over --calls calls after 3 warm, summed over the call's
kernels, with their names; beside K1 and K2 their bound (the larger of the
bytes, q, k, v read once and the output written once, over 3.35 TB/s and
the operations, two products a live (query, key) pair, over 989 TFLOP/s,
as `chip_smoke.py` counts them) and one `scaled_dot_product_attention`
call on the frames or patch columns laid out for it. Backward at (16, 4),
(16, 16), (8, 32) and (8, 4): K4 through its wrapper, then K6 adding to
the rows K4 wrote from K4's `cls_part` and K3's output and lse0 (as the
autograd Function runs them), each with its bound (`chip_smoke.py`'s) and,
for K4, the backward of one library call on the frames. Then K7 and K8 at
R x 768 for the paths' row counts, bf16 and f32, and at the heads' f32 shapes
(8,192 and 480 x 128, 4,000 x 768), through their wrappers,
walking input sets of 4x the L2 cache as phase 3 does: K7 beside its plain
version, one `F.layer_norm` call and its bound (x read and y written once) and the
host's time a call of its wrapper (before it waits for the card), with the
geometry of `layernorm_fwd_geometry` where the tree has one; K8 each launch's time
beside one `F.layer_norm` backward (autograd) and its bound. It runs on any tree of
the port: run the script of this tree from the root of each (parent,
change, change, parent), and it measures that tree's kernels. `--only host`
reads the host's time a call of K7's and K9's wrappers where the card
keeps up (`_kernels.layernorm_fwd` at 240 x 768 bf16, the pretrain step's
text rows; `flash.flash_attention` at the i2t of B=16, S=785 over 15 masked
keys): HOST_CALLS calls timed together, HOST_REPS times, the median and
the range per call, the wrappers in turns. Where the tree has K9's ring
form, K9's C entry point alone is timed too, at the ring form's geometry
and at the chunked form's. The card's name and power limit (nvidia-smi)
head the output.
"""

import argparse
import os
import subprocess
import sys
import time
from types import SimpleNamespace

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd() if os.path.isdir("egovlpv2_torch") else here)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.nn import functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from egovlpv2_torch.ops import _kernels, flash  # noqa: E402
from egovlpv2_torch.ops import layernorm as ln  # noqa: E402
from egovlpv2_torch.ops.attention import make_additive_mask  # noqa: E402

H, DH, N = 12, 64, 196
FWD_CASES = ((20, 4), (20, 16), (16, 4), (8, 32), (64, 16), (16, 5), (8, 4))
BWD_CASES = ((16, 4), (16, 16), (8, 32), (8, 4))
LN_ROWS = (120, 240, 6280, 12560, 15696, 50184, 62740, 200768)
# the downstream heads' f32 LayerNorms (chip_smoke.py's HEAD_LN_CASES):
# VSLNet's video and query rows at D=128, the QFVS scorer's at D=768
HEAD_LN_SHAPES = [(torch.float32, 32 * 256, 128), (torch.float32, 32 * 15, 128),
                  (torch.float32, 20 * 200, 768)]
L2_BYTES = 50e6
PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet
PEAK_BF16 = 989e12  # dense tensor-core bf16, the same
HOST_CALLS, HOST_REPS = 2000, 11


def bound(kind: str, b: int, frames: int) -> str:
    """The least time of one bf16 call at H=12, Dh=64, S = 1 + 196 frames,
    as `chip_smoke.py`'s `bound_ms` counts it: kind "space_fwd",
    "time_fwd", "space_bwd" or "cls_row_bwd". Returns "<ms> ms (<by>)"."""
    s = 1 + frames * N
    head_rows = b * H * DH
    if kind == "cls_row_bwd":
        queries, keys, rows, products = 1, s, 1 + 2 * s + 1 + 1 + 2 * s, 5
    else:
        queries, keys = s - 1, (N if kind.startswith("space") else frames) + 1
        rows, products = ((4 * s - 2, 2) if kind.endswith("_fwd")
                          else (2 * queries + 2 * s + 3 * queries, 5))
    t_bytes = rows * head_rows * 2 / PEAK_BYTES_S
    t_flops = products * 2 * b * H * queries * keys * DH / PEAK_BF16
    by = "bytes" if t_bytes >= t_flops else "operations"
    return f"{max(t_bytes, t_flops) * 1e3:.4f} ms ({by})"


def device_events(fn, calls: int) -> dict:
    """`fn` `calls` times under torch.profiler after 3 warm calls: the
    device ms a call of each kernel or copy, by name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the tracer now and then hands back no event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = {e.key: e.self_device_time_total / 1e3 / calls
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total}
        if events:
            return events
    raise AssertionError("torch.profiler recorded no device event")


def _ms(fn, calls: int) -> float:
    return sum(device_events(fn, calls).values())


def _short(name: str) -> str:
    """A kernel's name without its namespaces, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def _names(events: dict) -> str:
    return "+".join(sorted({_short(k) for k in events}))


def _by_kernel(events: dict) -> str:
    return " + ".join(f"{_short(k)} {ms:.4f}" for k, ms in sorted(
        events.items()))


def _qkv(b: int, frames: int, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(b * 100 + frames)
    s = 1 + frames * N
    return torch.randn((b, s, 3, H, DH), generator=gen, device="cuda").to(dtype)


def _frames_for_sdpa(qkv: torch.Tensor, frames: int) -> tuple:
    """q [B, H, F, N, Dh] and k, v [B, H, F, N + 1, Dh] (the CLS key in
    front of each frame), contiguous, for one library call."""
    b, s = qkv.shape[:2]
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def frame(t):
        return t[:, :, 1:].reshape(b, H, frames, N, DH)

    def with_cls(t):
        return torch.cat([t[:, :, None, :1].expand(b, H, frames, 1, DH),
                          frame(t)], dim=3)

    return (frame(q).contiguous(), with_cls(k).contiguous(),
            with_cls(v).contiguous())


def _columns_for_sdpa(qkv: torch.Tensor, frames: int) -> tuple:
    """q [B, H, N, F, Dh] and k, v [B, H, N, F + 1, Dh] (the CLS key in
    front of each patch column), contiguous, for one library call."""
    b, s = qkv.shape[:2]
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def cols(t):
        return t[:, :, 1:].reshape(b, H, frames, N, DH).transpose(2, 3)

    def with_cls(t):
        return torch.cat([t[:, :, None, :1].expand(b, H, N, 1, DH), cols(t)],
                         dim=3)

    return (cols(q).contiguous(), with_cls(k).contiguous(),
            with_cls(v).contiguous())


def attention(calls: int) -> None:
    scale = DH ** -0.5
    for b, frames in FWD_CASES:
        qkv = _qkv(b, frames)
        s = qkv.shape[1]
        flat = qkv.view(b, s, 3 * H * DH)
        out = torch.empty((b, s, H * DH), dtype=qkv.dtype, device="cuda")
        lse0 = torch.empty((b, H), device="cuda")
        kw = dict(num_heads=H, num_frames=frames, scale=scale)
        runs = {"K1": lambda: _kernels.space_attention_fwd(flat, out, **kw),
                "K2": lambda: _kernels.time_attention_fwd(flat, out, **kw),
                "K3": lambda: _kernels.cls_row_attention_fwd(
                    flat, out, lse0, num_heads=H, scale=scale)}
        line = []
        for name, fn in runs.items():
            events = device_events(fn, calls)
            line.append(f"{name} {sum(events.values()):.4f} ms "
                        f"[{_names(events)}]")
        libs = []
        for name, layout in (("K1", _frames_for_sdpa),
                             ("K2", _columns_for_sdpa)):
            q, k, v = layout(qkv, frames)
            lib = _ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                             scale=scale),
                      calls)
            libs.append(f"{name} library {lib:.4f} ms")
            del q, k, v
        print(f"[attention] bf16 B={b} S={s} F={frames}: {'  '.join(line)}  "
              f"K1 bound {bound('space_fwd', b, frames)}  K2 bound "
              f"{bound('time_fwd', b, frames)}  {'  '.join(libs)}",
              flush=True)


def backward(calls: int) -> None:
    scale = DH ** -0.5
    for b, frames in BWD_CASES:
        qkv = _qkv(b, frames)
        s = qkv.shape[1]
        flat = qkv.view(b, s, 3 * H * DH)
        gen = torch.Generator(device="cuda").manual_seed(b * 100 + frames + 1)
        g = torch.randn((b, s, H * DH), generator=gen, device="cuda").to(
            qkv.dtype)
        dqkv = torch.empty_like(flat)
        out0 = torch.empty((b, s, H * DH), dtype=qkv.dtype, device="cuda")
        lse0 = torch.empty((b, H), device="cuda")
        _kernels.cls_row_attention_fwd(flat, out0, lse0, num_heads=H,
                                       scale=scale)
        stats, parts = _kernels.attention_bwd_scratch(
            flat, num_heads=H, num_frames=frames, axis="space")
        kw = dict(num_heads=H, num_frames=frames, scale=scale)
        k4 = device_events(lambda: _kernels.space_attention_bwd(
            flat, g, dqkv, stats, parts, **kw), calls)
        k6 = device_events(lambda: _kernels.cls_row_attention_bwd(
            flat, g, out0, lse0, dqkv, parts, num_heads=H, scale=scale), calls)
        leaves = [t.detach().requires_grad_(True)
                  for t in _frames_for_sdpa(qkv, frames)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        cot = g.view(b, s, H, DH).transpose(1, 2)[:, :, 1:].reshape(
            b, H, frames, N, DH).contiguous()
        lib = _ms(lambda: torch.autograd.grad(out, leaves, cot,
                                              retain_graph=True), calls)
        print(f"[backward] bf16 B={b} S={s} F={frames}: K4 "
              f"{sum(k4.values()):.4f} ms [{_by_kernel(k4)}] bound "
              f"{bound('space_bwd', b, frames)} library {lib:.4f} ms; K6 after "
              f"it ({parts.shape[2]} cls_part rows a (b, h)) "
              f"{sum(k6.values()):.4f} ms [{_names(k6)}] bound "
              f"{bound('cls_row_bwd', b, frames)}", flush=True)
        del leaves, out, cot, dqkv, stats, parts
        torch.cuda.empty_cache()


def _ln_sets(rows: int, d: int, dtype) -> list:
    """Input sets (x, g, dx) walking 4x the L2 cache in all (at most 8)."""
    gen = torch.Generator(device="cuda").manual_seed(rows)
    e = torch.finfo(dtype).bits // 8
    n_sets = int(min(8, max(1, -(-4 * L2_BYTES // (3 * rows * d * e)))))
    sets = []
    for _ in range(n_sets):
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 0.7
             + 1.5).to(dtype)
        g = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
        sets.append((x, g, torch.empty_like(x)))
    return sets


def layernorm_fwd(sets, rows: int, d: int, dtype, calls: int) -> None:
    """K7 on `sets` (x, _, y), beside its plain version, one
    `F.layer_norm` call and its bound."""
    scale = torch.ones(d, device="cuda") + 0.1
    bias = torch.full((d,), 0.1, device="cuda")
    w, b = scale.to(dtype), bias.to(dtype)
    turn = [0]

    def next_set():
        turn[0] += 1
        return sets[turn[0] % len(sets)]

    def kernel():
        x, _, y = next_set()
        _kernels.layernorm_fwd(x, scale, bias, y, eps=1e-5)

    events = device_events(kernel, calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):  # the host's time a call, before it waits
        kernel()
    host = (time.perf_counter() - t0) * 1e6 / calls
    lib = _ms(lambda: F.layer_norm(next_set()[0], (d,), w, b, 1e-5), calls)
    plain = _ms(lambda: ln.layernorm_reference(next_set()[0], scale, bias,
                                               eps=1e-5), calls)
    e = torch.finfo(dtype).bits // 8
    bound = (2 * rows * d * e + 2 * d * 4) / PEAK_BYTES_S * 1e3
    geometry = getattr(_kernels, "layernorm_fwd_geometry", None)
    geo = "" if geometry is None else \
        f" ({geometry(dtype, rows, d).slots} pieces a thread)"
    print(f"[layernorm_fwd] {str(dtype).split('.')[-1]} R={rows} D={d}: "
          f"kernel {sum(events.values()):.4f} ms [{_by_kernel(events)}]"
          f"{geo} plain {plain:.4f} ms library {lib:.4f} ms bound "
          f"{bound:.4f} ms; the host "
          f"{host:.1f} us a call [{len(sets)} input sets]", flush=True)


def layernorm(calls: int) -> None:
    shapes = [(dtype, rows, 768) for dtype in (torch.bfloat16, torch.float32)
              for rows in LN_ROWS] + HEAD_LN_SHAPES
    for dtype, rows, d in shapes:
        sets = _ln_sets(rows, d, dtype)
        layernorm_fwd(sets, rows, d, dtype, calls)
        scale = torch.ones(d, device="cuda") + 0.1
        dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
        partials = _kernels.layernorm_bwd_scratch(sets[0][0])
        turn = [0]

        def kernel():
            turn[0] += 1
            x, g, dx = sets[turn[0] % len(sets)]
            _kernels.layernorm_bwd(x, scale, g, dx, dscale, dbias,
                                   partials, eps=1e-5)

        graphs = []
        for x, g, _ in sets:
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, scale.to(dtype), scale.to(dtype))]
            graphs.append((F.layer_norm(leaves[0], (d,), leaves[1],
                                        leaves[2], 1e-5), leaves, g))

        def library():
            turn[0] += 1
            y, leaves, g = graphs[turn[0] % len(graphs)]
            torch.autograd.grad(y, leaves, g, retain_graph=True)

        events = device_events(kernel, calls)
        e = torch.finfo(dtype).bits // 8
        bound = (3 * rows * d * e + 3 * d * 4) / PEAK_BYTES_S * 1e3
        print(f"[layernorm_bwd] {str(dtype).split('.')[-1]} R={rows} "
              f"D={d}: kernel {sum(events.values()):.4f} ms "
              f"[{_by_kernel(events)}] library {_ms(library, calls):.4f} ms "
              f"bound {bound:.4f} ms [{len(sets)} input sets]", flush=True)
        del sets, graphs
        torch.cuda.empty_cache()


def _k9_entry(q, k, v, bias, out, geo):
    """One call of K9's C entry point at `geo`, as the wrapper makes it
    (no partials: a many-query form)."""
    b, h, sq, dh = q.shape
    strides = [x for t in (q, k, v, out) for x in _kernels.attention_strides(t)]
    code = _kernels.load().fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None, _kernels._DTYPE_CODES[q.dtype], b, h, sq,
        k.shape[2], dh, *strides, bias.stride(0), 0, DH ** -0.5,
        _kernels._FLASH_FORMS[geo.form], geo.run or 0, geo.splits,
        geo.row_tiles or 0, geo.stages or 0, geo.shared_bytes or 0,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"fused_attention_fwd: CUDA error {code}")


def host(calls: int) -> None:
    """The host's time a call of K7's and K9's wrappers (module doc)."""
    del calls  # HOST_CALLS: enough that the host's noise averages out
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((240, 768), generator=gen, device="cuda").bfloat16()
    y, scale, bias = torch.empty_like(x), torch.ones(768, device="cuda"), \
        torch.zeros(768, device="cuda")

    def heads(s):
        return torch.randn((16, s, H, DH), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)

    q, k, v = heads(785), heads(15), heads(15)
    mask = torch.rand((16, 15), generator=gen, device="cuda") > 0.3
    mask[:, 0] = True
    bias_k = make_additive_mask(mask.long())
    wrappers = {
        "K7 layernorm_fwd R=240": lambda: _kernels.layernorm_fwd(
            x, scale, bias, y, eps=1e-5),
        "K9 flash_attention i2t B=16 S=785": lambda: flash.flash_attention(
            q, k, v, scale=DH ** -0.5, bias=bias_k)}
    if "many_queries_chunked" in getattr(_kernels, "_FLASH_FORMS", {}):
        out = torch.empty_like(q)
        ring = _kernels.flash_fwd_geometry(torch.bfloat16, DH, 785, 15, 16, H)
        chunked = SimpleNamespace(form="many_queries_chunked", run=None,
                                  splits=1, row_tiles=None, stages=None,
                                  shared_bytes=None)
        for name, geo in (("the ring form", ring), ("the chunked form",
                                                     chunked)):
            wrappers[f"K9's C entry alone, {name}"] = \
                lambda geo=geo: _k9_entry(q, k, v, bias_k, out, geo)
    times = {w: [] for w in wrappers}
    for _ in range(HOST_REPS):
        for w, fn in wrappers.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            times[w].append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
            torch.cuda.synchronize()
    for w, us in times.items():
        us = sorted(us)
        print(f"[host] {w}: median {us[len(us) // 2]:.2f} us a call (range "
              f"{us[0]:.2f}-{us[-1]:.2f}, {HOST_REPS} x {HOST_CALLS} calls)",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--only", nargs="+",
                        choices=("attention", "backward", "layernorm",
                                 "host"),
                        default=("attention", "backward", "layernorm"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}; tree {os.getcwd()}", flush=True)
    _kernels.load()
    for part in ("attention", "backward", "layernorm", "host"):
        if part in args.only:
            globals()[part](args.calls)


if __name__ == "__main__":
    main()
