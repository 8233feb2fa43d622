"""The step's useful operations (perfbench/flops.py: counted from the
shapes and paths, nothing computed twice) times the window's steps, over
the window's seconds, as a share of the cards' bf16 tensor-core peak."""

from perfbench import peaks


def read(ctx):
    w = ctx.window
    rate = ctx.flops["useful"] * w["steps"] / (w["t1"] - w["t0"])
    return 100.0 * rate / (peaks.FLOPS["bfloat16"] * ctx.chips)
