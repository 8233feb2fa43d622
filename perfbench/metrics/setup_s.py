"""Seconds from the process's start to the first timed step: building or
loading the kernels, the seeded weights and inputs, and the checked first
steps, which warm every shape the window uses (host clock)."""


def read(ctx):
    return ctx.setup_s
