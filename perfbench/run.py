#!/usr/bin/env python3
"""Runs one cell of the benchmark of the PyTorch/CUDA port and prints its
result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (`BENCHMARK.json`). With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, the device's
busy seconds and a breakdown. Every run compares the program's first
steps with the plain reference (perfbench/reference/) and prints each
compared number beside its limit, last on standard error and under
"checks" at the end of the line. Without the cards, or if JAX or the JAX
package is loaded once the window has closed, it exits non-zero and prints
no result.

Caches stay inside the checkout at fixed paths: the port builds its
kernels into build/egovlpv2_torch/; Triton, torch extensions and the CUDA
JIT cache go under build/perfbench/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "egovlpv2_tpu")


def process_age() -> float:
    """Seconds since this process started (/proc: its start tick against
    the uptime, both to 10 ms), or 0 where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness, manifest

    bench = manifest.load(ROOT)
    chips = manifest.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"perfbench: {args.workload} asks for {chips} cards; this "
              "harness runs one-card cells", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
