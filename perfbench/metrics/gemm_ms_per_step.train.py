"""Device milliseconds a step of cuBLAS's matrix products, forward and
backward: the kernels of the GEMM kind by name (perfbench/kinds.py) in the
device-only stretch, over its steps."""

from perfbench import kinds


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds = kinds.family_seconds(ctx.timeline, "gemm")
    return None if seconds is None else seconds * 1e3 / ctx.stretch_steps
