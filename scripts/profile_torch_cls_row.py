"""Device time of the CLS-row kernels K3 and K6 by launch, on one CUDA card.

    python3 scripts/profile_torch_cls_row.py [--calls 20]

K3 (`cls_row_attention_fwd`) and K6 (`cls_row_attention_bwd`) each make two
launches on `cls_row_geometry`: a pass over runs of keys, then a merge. For
each shape `chip_smoke.py` gives them (H=12, Dh=64, bf16 and f32), this
script prints the device time a call of each launch from torch.profiler (the
mean over `--calls` calls after 3 warm ones), K3's error against the plain
version, and one library call's time (`scaled_dot_product_attention` of the
CLS query over all keys). K6 adds to a zeroed dqkv and sums zero K4/K5
partials of the count K5 writes at that shape, as the step runs it after
K5.

The package is imported from the current directory when it holds one, so that
two trees can be compared inside one call. The card's name and power limit
(nvidia-smi) head the output.
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
from egovlpv2_torch.ops.divided import cls_row_reference  # noqa: E402

H, DH, N = 12, 64, 196
# (B, frames): the fine-tune's, EgoMCQ's, an MQ/NLQ inner batch's, the
# pretrain step's (forward and backward), QFVS's, the EgoTaskQA step's
CASES = ((8, 32), (20, 16), (64, 16), (16, 16), (16, 4), (16, 5), (8, 4))


def _by_launch(fn, calls: int) -> dict:
    """"part" and "merge": each launch's device time a call, ms."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            kind = "merge" if "merge" in e.key else "part"
            out[kind] = out.get(kind, 0.0) \
                + e.self_device_time_total / 1e3 / calls
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cls_row: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    scale = DH ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for b, frames in CASES:
            s = 1 + frames * N
            qkv = torch.randn((b, s, 3, H, DH), generator=gen,
                              device="cuda").to(dtype)
            g = torch.randn((b, s, H, DH), generator=gen,
                            device="cuda").to(dtype)
            flat, gflat = qkv.view(b, s, -1), g.view(b, s, -1)
            ref = cls_row_reference(qkv.float(), scale=scale).reshape(b, -1)
            _, cls_part = _kernels.attention_bwd_scratch(
                flat, num_heads=H, num_frames=frames, axis="time")
            cls_part.zero_()
            q0, k, v = (t.transpose(1, 2).contiguous()
                        for t in (qkv[:, :1, 0], qkv[:, :, 1], qkv[:, :, 2]))
            lib = sum(_by_launch(lambda: F.scaled_dot_product_attention(
                q0, k, v, scale=scale), args.calls).values())
            out = torch.empty((b, s, H * DH), dtype=dtype, device="cuda")
            lse = torch.empty((b, H), device="cuda")
            dqkv = torch.zeros_like(flat)
            fwd = lambda: _kernels.cls_row_attention_fwd(
                flat, out, lse, num_heads=H, scale=scale)
            bwd = lambda: _kernels.cls_row_attention_bwd(
                flat, gflat, out, lse, dqkv, cls_part, num_heads=H,
                scale=scale)
            fwd()
            torch.cuda.synchronize()
            err = (out[:, 0].float() - ref).abs().max().item()
            tf, tb = _by_launch(fwd, args.calls), _by_launch(bwd, args.calls)
            geo = _kernels.cls_row_geometry(dtype, DH, s)
            print(f"{str(dtype).split('.')[-1]} B={b} S={s} (run {geo.run}, "
                  f"{geo.parts} parts): K3 {sum(tf.values()):.4f} ms = part "
                  f"{tf['part']:.4f} + merge {tf['merge']:.4f} (err "
                  f"{err:.1e}); K6 {sum(tb.values()):.4f} = part "
                  f"{tb['part']:.4f} + merge {tb['merge']:.4f}; library "
                  f"{lib:.4f}", flush=True)
            del qkv, g, flat, gflat, out, dqkv, cls_part, q0, k, v
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
