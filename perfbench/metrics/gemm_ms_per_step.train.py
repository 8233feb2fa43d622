"""Device milliseconds a step of the kernels launched inside the matrix-
product operators (aten::mm, addmm, bmm, baddbmm, linear, matmul), forward
and backward, each kernel once (the profiled stretch)."""

GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::linear", "aten::matmul")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    corrs = [c for r in tr.ranges if r.name in GEMM_OPS
             for c in tr.corr_under(r)]
    if not corrs:
        return None
    return tr.device_us(corrs) / 1e3 / ctx.stretch_steps
