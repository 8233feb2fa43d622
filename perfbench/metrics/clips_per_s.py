"""Clips completed per second: every row of every step of the window (the
whole group's rows over several cards), over the window's seconds from the
first step's launch to the final synchronisation (host clock)."""


def read(ctx):
    w = ctx.window
    return w["steps"] * ctx.rows * ctx.chips / (w["t1"] - w["t0"])
