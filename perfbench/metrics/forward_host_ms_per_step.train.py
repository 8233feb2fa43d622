"""The host's milliseconds a step inside the program's span
`egovlpv2.step.forward` (the loss function: the towers, the fused paths
and the losses, as launched), averaged over the untraced window's steps,
from the port's own ring of spans (program span)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "forward")
