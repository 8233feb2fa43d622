"""Device milliseconds a step of the kernels launched inside the
optimizer's step (`Optimizer.step#AdamW.step`; the profiled stretch)."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    corrs = [c for r in tr.named("Optimizer.step#") for c in tr.corr_under(r)]
    if not corrs:
        return None
    return tr.device_us(corrs) / 1e3 / ctx.stretch_steps
