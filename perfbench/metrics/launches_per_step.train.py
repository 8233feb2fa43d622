"""Launches a step that put work on the device (kernel launches, copies
and sets, through the runtime or the driver), on every thread (the
backward launches from the autograd engine's), inside the program's
`egovlpv2.step` ranges of the host-and-device stretch, over its steps."""

from perfbench import program_spans


def read(ctx):
    counts = program_spans.launches_per_step(ctx.trace)
    if counts is None or len(counts) != ctx.stretch_steps:
        return None
    return sum(counts) / len(counts)
