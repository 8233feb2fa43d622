"""The fused attention's least time over its device time, as a share: the
same reading as divided_attn_roofline.train over the step's calls of the
port's `ops.flash.flash_attention` (forward only: its backward is plain
PyTorch; q, k, v and the bias read once, the output written once, two
products a visible (query, key) pair on the tensor cores in a 16-bit type;
perfbench/bounds.py) and the device time of K9's kernels by name."""

from perfbench import bounds


def read(ctx):
    return bounds.roofline_share(ctx, "fused_attn")
