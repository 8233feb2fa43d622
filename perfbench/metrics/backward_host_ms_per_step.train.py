"""The host's milliseconds a step inside the program's span
`egovlpv2.step.backward` (the main thread's wait on the autograd engine,
which launches the backward's kernels), averaged over the untraced
window's steps, from the port's own ring of spans (program span)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "backward")
