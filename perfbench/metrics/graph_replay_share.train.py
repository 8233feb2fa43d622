"""The share of the untraced window's steps that the program replayed as
one CUDA graph, in %: the steps whose `egovlpv2.step` holds an
`egovlpv2.step.replay` span in the port's own ring (program span). Nothing
where the program records no such span (a program without the graph step)
or the ring lacks one of the window's steps."""

from perfbench import program_spans

REPLAY = "egovlpv2.step.replay"


def read(ctx):
    try:
        from egovlpv2_torch.utils import logging as program_logging
    except ImportError:
        return None
    if getattr(program_logging, "REPLAY", None) != REPLAY:
        return None
    steps = program_spans.window_steps(ctx)
    if not steps:
        return None
    replayed = sum(any(s.name == REPLAY for s in step) for step in steps)
    return 100.0 * replayed / len(steps)
