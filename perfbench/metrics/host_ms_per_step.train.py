"""The host's milliseconds inside the training step's call, from call to
return (the enqueue), averaged over the window's steps; the profiled
stretch, which the profiler slows, is not among them (host clock)."""


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * sum(ctx.spans) / len(ctx.spans)
