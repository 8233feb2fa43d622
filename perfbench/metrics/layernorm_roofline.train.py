"""LayerNorm's least time over its device time, as a share: the same
reading as divided_attn_roofline.train over the step's calls of the port's
`ops.layernorm.layernorm` (bytes over the memory's peak and float32
operations outside the tensor cores, perfbench/bounds.py) and the device
time of K7/K8 by name."""

from perfbench import bounds


def read(ctx):
    return bounds.roofline_share(ctx, "layernorm")
