"""Device milliseconds a step of AdamW's updates: the kernels of the
optimizer kind by name (the foreach `multi_tensor` and `adam` kernels,
perfbench/kinds.py) in the device-only stretch, over its steps."""

from perfbench import kinds


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds = kinds.family_seconds(ctx.timeline, "adamw")
    return None if seconds is None else seconds * 1e3 / ctx.stretch_steps
