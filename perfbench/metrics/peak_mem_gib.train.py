"""The device memory that the program holds at its peak over the window
(GiB): the allocator's reserved bytes, its peak reset at the window's
start. A replayed step's working set lies in its CUDA graph's private
pool, which stays reserved between replays while its blocks read free; an
eager step's is the segments its tensors took, cached blocks among them."""


def read(ctx):
    return (ctx.reserved_window_bytes / 2 ** 30
            if ctx.reserved_window_bytes else None)
