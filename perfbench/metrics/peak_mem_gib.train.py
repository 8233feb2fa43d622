"""The device memory allocated at its peak over the window (GiB), after
the peak was reset at the window's start."""


def read(ctx):
    return ctx.peak_window_bytes / 2 ** 30 if ctx.peak_window_bytes else None
