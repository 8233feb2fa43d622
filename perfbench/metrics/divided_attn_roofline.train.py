"""The divided attention's least time over its device time, as a share.

Least time: over the stretch's calls of the port's `divided_attention`
(ranges the benchmark puts around each call, with its shapes), forward and,
where the call's output took a gradient, backward, the larger of bytes
over the memory's peak and operations over the peak of their type
(perfbench/bounds.py). Device time: the kernels launched inside each call's
range and inside the autograd nodes of the ops recorded in it, whatever
their names."""

from perfbench import bounds, trace

OP = "divided_attn"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    least = device = 0.0
    for r in tr.named("perfbench." + OP + "|"):
        _, f = trace.parse_call(r.name)
        shape = dict(b=int(f["b"]), s=int(f["s"]), h=int(f["h"]),
                     dh=int(f["dh"]), frames=int(f["frames"]),
                     axis=f["axis"], dtype=f["dtype"])
        tensor = f["dtype"] != "float32"
        ops, nbytes = bounds.divided_attention(**shape, backward=False)
        least += bounds.least_seconds(ops, nbytes, f["dtype"], tensor)
        device += tr.device_us(tr.corr_under(r)) / 1e6
        nodes = tr.backward_of(r)
        corrs = [c for n in nodes for c in tr.corr_under(n)]
        if corrs:
            ops, nbytes = bounds.divided_attention(**shape, backward=True)
            least += bounds.least_seconds(ops, nbytes, f["dtype"], tensor)
            device += tr.device_us(corrs) / 1e6
    return 100.0 * least / device if device > 0 else None
