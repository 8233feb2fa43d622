"""Device time a call of the divided-attention forward (K1, K2, K3) and of
the LayerNorm backward (K8) at the shapes of `chip_smoke.py`'s phase 3, on
one CUDA card.

    python3 scripts/profile_torch_kernels.py [--calls 20]

H=12, Dh=64, bf16, at (B, frames) = (20, 4), (20, 16), (16, 4), (8, 32),
(64, 16), (16, 5) and (8, 4) (S = 1 + 196 frames), K1, K2 and K3 through their wrappers, each on one qkv: the mean device time a call
from torch.profiler over --calls calls after 3 warm, summed over the call's
kernels, with their names; for K2 also its bound (bytes: q, k, v read once,
the output written once, as `chip_smoke.py` counts them) and one
`scaled_dot_product_attention` call on the patch columns laid out for it.
Then K8 at R x 768 for the paths' row counts, bf16 and f32, through its
wrapper, walking input sets of 4x the L2 cache as phase 3 does, each
launch's time beside one `F.layer_norm` backward (autograd) and its bound.
It runs on any tree of the port: run the script of this tree from
the root of each (parent, change, change, parent), and it measures that
tree's kernels. The card's name and power limit (nvidia-smi) head the
output.
"""

import argparse
import os
import subprocess
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd() if os.path.isdir("egovlpv2_torch") else here)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.nn import functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from egovlpv2_torch.ops import _kernels  # noqa: E402

H, DH, N = 12, 64, 196
FWD_CASES = ((20, 4), (20, 16), (16, 4), (8, 32), (64, 16), (16, 5), (8, 4))
LN_ROWS = (120, 240, 6280, 12560, 15696, 50184, 200768)
L2_BYTES = 50e6
PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet


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
        q, k, v = _columns_for_sdpa(qkv, frames)
        lib = _ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                  calls)
        bound = (4 * s - 2) * b * H * DH * 2 / PEAK_BYTES_S * 1e3
        print(f"[attention] bf16 B={b} S={s} F={frames}: {'  '.join(line)}  "
              f"K2 bound {bound:.4f} ms (bytes) library {lib:.4f} ms",
              flush=True)


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


def layernorm(calls: int) -> None:
    d = 768
    for dtype in (torch.bfloat16, torch.float32):
        for rows in LN_ROWS:
            sets = _ln_sets(rows, d, dtype)
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}; tree {os.getcwd()}", flush=True)
    _kernels.load()
    attention(args.calls)
    layernorm(args.calls)


if __name__ == "__main__":
    main()
