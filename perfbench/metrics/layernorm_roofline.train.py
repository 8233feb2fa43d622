"""LayerNorm's least time over its device time, as a share: the same
reading as divided_attn_roofline.train over the calls of the port's
`ops.layernorm.layernorm` (bytes over the memory's peak and float32
operations outside the tensor cores, perfbench/bounds.py)."""

from perfbench import bounds, trace

OP = "layernorm"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    least = device = 0.0
    for r in tr.named("perfbench." + OP + "|"):
        _, f = trace.parse_call(r.name)
        rows, d, dtype = int(f["rows"]), int(f["d"]), f["dtype"]
        ops, nbytes = bounds.layernorm(rows, d, dtype, backward=False)
        least += bounds.least_seconds(ops, nbytes, dtype, False)
        device += tr.device_us(tr.corr_under(r)) / 1e6
        corrs = [c for n in tr.backward_of(r) for c in tr.corr_under(n)]
        if corrs:
            ops, nbytes = bounds.layernorm(rows, d, dtype, backward=True)
            least += bounds.least_seconds(ops, nbytes, dtype, False)
            device += tr.device_us(corrs) / 1e6
    return 100.0 * least / device if device > 0 else None
