"""Device time of the fused attention kernel (K9) a call, on one CUDA card.

    python3 scripts/profile_torch_flash.py [--calls 30]

`chip_smoke.py` times a wrapper call with CUDA events, and below about 0.2 ms
that reads the host's time to issue the call, not the kernel's. This script
reads the kernel's own time from torch.profiler: for each shape the models
give `flash_attention` (H=12, Dh=64; q, k and v transposed views of
[B, S, H*Dh] projections; a padding mask where the models have one), bf16 and
f32, the mean device time of the kernel over `--calls` calls after 3 warm
ones, and the kernel's name (which of the two forms ran).

The package is imported from the current directory when it holds one, so that
two trees can be compared inside one call: run the script of this tree from
the root of each (parent, change, change, parent). The card's name and power
limit (nvidia-smi) head the output.
"""

import argparse
import os
import subprocess
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd() if os.path.isdir("egovlpv2_torch") else here)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from egovlpv2_torch.ops import flash  # noqa: E402
from egovlpv2_torch.ops.attention import make_additive_mask  # noqa: E402

H, DH = 12, 64
# (label, B, Sq, Sk, masked)
CASES = (
    ("i2t", 64, 3137, 15, True), ("i2t", 20, 3137, 15, True),
    ("i2t", 16, 981, 15, True), ("i2t", 16, 785, 15, True),
    ("t2i", 64, 15, 3137, False), ("t2i", 20, 15, 3137, False),
    ("t2i", 16, 15, 981, False), ("t2i", 16, 15, 785, False),
    ("text self", 64, 15, 15, True), ("text self", 8, 30, 30, True),
    ("above 32", 16, 197, 197, False), ("above 32", 16, 64, 64, True),
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flash: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    root = os.path.abspath(flash.__file__)
    for _ in range(3):  # <root>/egovlpv2_torch/ops/flash.py
        root = os.path.dirname(root)
    tree = os.path.basename(root)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def heads(b, s, dtype):
        return torch.randn((b, s, H, DH), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)

    for dtype in (torch.bfloat16, torch.float32):
        for label, b, sq, sk, masked in CASES:
            q, k, v = heads(b, sq, dtype), heads(b, sk, dtype), heads(b, sk, dtype)
            bias = None
            if masked:
                mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
                mask[:, 0] = True
                bias = make_additive_mask(mask.long())
            for _ in range(3):
                flash.flash_attention(q, k, v, scale=DH ** -0.5, bias=bias)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    flash.flash_attention(q, k, v, scale=DH ** -0.5, bias=bias)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and "fused" in e.key:
                    print(f"[k9 {tree}] {str(dtype).split('.')[-1]:8s} "
                          f"{label:9s} B={b} Sq={sq} Sk={sk}: "
                          f"{e.self_device_time_total / e.count:.1f} us a call "
                          f"(x{e.count})  {e.key[:70]}", flush=True)


if __name__ == "__main__":
    main()
