"""The host's milliseconds a step inside the program's span
`egovlpv2.step.zero_grad` and `egovlpv2.step.optimizer` (the zero fill
of unreached gradients, the gradient sync, the clip or norm, AdamW and
the scheduler), averaged over the untraced window's steps, from the
port's own ring of spans (program span)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "optimizer")
