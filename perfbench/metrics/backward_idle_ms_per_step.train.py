"""The device's idle milliseconds a step while the host was inside the
program's span `egovlpv2.step.backward`: the device-only stretch's idle
time (no kernel, copy or set running) cut at the ring's spans of its
steps, placed on the profiler's clock by the offset that the host-and-
device stretch's ranges of the same spans give
(perfbench/program_spans.py)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "backward")
