"""The divided attention's least time over its device time, as a share.

Least time: over the step's calls of the port's `divided_attention`, counted
from the cell's shapes and paths (`ctx.calls`, perfbench/bounds.py), forward
and, where the call's output reaches a loss, backward, the larger of bytes
over the memory's peak and operations over the peak of their type, times
the profiled steps. Device time: the kernels that do its work, by name
(K1-K6, and K10/K11 where they serve it; perfbench/kinds.py), in the
device-only stretch, however they were launched."""

from perfbench import bounds


def read(ctx):
    return bounds.roofline_share(ctx, "divided_attn")
