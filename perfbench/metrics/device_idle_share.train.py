"""The share of a profiled stretch of steps (the device traced alone, from
the first step's launch after a synchronisation to the final one, host
clock) in which no operation ran on the device."""


def read(ctx):
    if ctx.timeline is None or ctx.timeline_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy_us() / 1e6 / ctx.timeline_s)
