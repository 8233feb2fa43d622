"""The readers of the program's spans (perfbench/program_spans.py) on a
synthetic ring and synthetic traces: the window's steps, the launches a
step across two threads, the clock's offset from the matched spans, and
the device-only stretch's idle time cut at an eager step's phases; each
finds nothing without a trace or without the ring."""

from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace as Context

import pytest

from perfbench import manifest, program_spans, trace

# the fields of the program's `utils/logging.py::Span`
Span = namedtuple("Span", "id name parent step start end thread")

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns
OFFSET = 5e9  # us from the ring's clock to the profiler's

# a step's spans from its start, in ms: (name, parent, start, end)
LAYOUT = [
    ("egovlpv2.step", None, 0.0, 9.5),
    ("egovlpv2.step.zero_grad", 0, 0.0, 1.0),
    ("egovlpv2.step.put", 0, 1.0, 1.1),
    ("egovlpv2.step.forward", 0, 1.1, 5.0),
    ("egovlpv2.forward.egonce", 3, 1.2, 4.0),
    ("egovlpv2.step.backward", 0, 5.0, 8.0),
    ("egovlpv2.step.optimizer", 0, 8.0, 9.0),
    ("egovlpv2.optimizer.grad_sync", 6, 8.1, 8.2),
    ("egovlpv2.optimizer.adamw", 6, 8.3, 8.9),
]


def make_ring(steps):
    """Spans of steps given as (start ms, scale of the layout's times)."""
    spans, next_id = [], 1
    for step, (t, scale) in enumerate(steps, start=1):
        ids = []
        for name, parent, a, b in LAYOUT:
            ids.append(next_id)
            spans.append(Span(next_id, name,
                              None if parent is None else ids[parent], step,
                              int((t + a * scale) * MS),
                              int((t + b * scale) * MS), 7))
            next_id += 1
    return spans


WINDOW = [10.0, 30.0]  # two steps inside 0-100 ms
TIMELINE = [200.0, 220.0]  # the device-only stretch
LINKED = [300.0, 320.0]  # the host-and-device stretch, its host slowed
RING = make_ring([(t, 1.0) for t in WINDOW + TIMELINE]
                 + [(t, 1.5) for t in LINKED])


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def us(ms):
    return ms * 1e3 + OFFSET


def linked_events():
    events = [X("user_annotation", trace.STRETCH, us(299), 40e3)]
    # the ranges start a little after their spans (jitter under 2 us)
    for i, s in enumerate(s for s in RING if s.start >= LINKED[0] * MS):
        events.append(X("user_annotation", s.name, s.start / 1e3 + OFFSET
                        + (i % 3) * 0.5, (s.end - s.start) / 1e3))
    corr = 1
    for t in LINKED:
        # forward: two kernels from the main thread; backward: one from
        # the autograd engine's thread; an event record puts no work on
        # the device
        for tid, at in ((1, t + 2), (1, t + 3), (2, t + 6)):
            events.append(X("cuda_runtime", "cudaLaunchKernel", us(at), 5,
                            tid=tid, correlation=corr))
            events.append(X("kernel", "k", us(at + 0.5), 100,
                            correlation=corr))
            corr += 1
        events.append(X("cuda_runtime", "cudaEventRecord", us(t + 6.5), 2,
                        tid=2, correlation=corr))
        corr += 1
    # a loss read after the step: a copy outside every step's range
    events.append(X("cuda_runtime", "cudaMemcpyAsync", us(339.8), 5,
                    correlation=corr))
    events.append(X("gpu_memcpy", "Memcpy DtoH", us(339.85), 10,
                    correlation=corr))
    return events


def timeline_events(shift=0.0):
    events = []
    for t in TIMELINE:
        # forward 1.1-5.0 busy 1.5-4.5 (idle 0.9); backward 5.0-8.0 busy
        # all through, its last kernel into the optimizer to 8.5; AdamW
        # 8.6-9.0 (optimizer idle: zero_grad 1.0 + 0.1)
        for a, b in ((t + 1.5, t + 4.5), (t + 5.0, t + 8.5),
                     (t + 8.6, t + 9.0)):
            events.append(X("kernel", "k", us(a) + shift, (b - a) * 1e3))
    return events


def context(**kw):
    c = Context(window={"t0": 0.0, "t1": 0.1, "steps": 2},
                trace=trace.Trace(linked_events()),
                timeline=trace.Trace(timeline_events()),
                timeline_s=30e-3, stretch_steps=2)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


@pytest.fixture
def ring(monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda: list(RING))


def read(name, ctx):
    return manifest.reader(ROOT, name).read(ctx)


def test_window_steps_from_the_ring(ring):
    steps = program_spans.window_steps(context())
    assert [len(s) for s in steps] == [len(LAYOUT)] * 2
    assert [s[0].start for s in steps] == [t * MS for t in WINDOW]


def test_launches_across_two_threads(ring):
    ctx = context()
    assert program_spans.launches_per_step(ctx.trace) == [3, 3]
    assert read("launches_per_step.train", ctx) == 3


def test_clock_from_the_matched_spans():
    tr = trace.Trace(linked_events())
    after = [s for s in RING if s.start > 0.1e9]
    c = program_spans.clock(tr, after)
    assert c["matched"] == 2 * len(LAYOUT)
    assert c["offset_us"] == pytest.approx(OFFSET + 0.5)
    assert c["range_us"] == pytest.approx(1.0)
    assert c["start_gap_us"] <= 0.5
    # the run of the device-only stretch has the same names, but not the
    # same offset: the linked stretch's run is the one matched
    assert c["spans"][0].start == LINKED[0] * MS


def test_idle_cut_at_the_phases(ring):
    ctx = context()
    parts = program_spans.idle_by_phase(ctx)
    got = [parts[p] / 1e3 / ctx.stretch_steps for p in program_spans.PHASES]
    assert got == pytest.approx([0.9, 0.0, 1.1], abs=2e-3)
    # a step's idle: its three phases and its put (0.1) and its own time
    # after the optimizer (0.5)
    assert parts["step"] / 2e3 == pytest.approx(0.9 + 1.1 + 0.1 + 0.5,
                                                 abs=2e-3)
    busy = 2 * (3.0 + 3.5 + 0.4)
    assert parts["all"] / 1e3 == pytest.approx(30.0 - busy)


def test_readers_find_nothing_without_a_trace(ring):
    empty = context(trace=None, timeline=None, timeline_s=0.0,
                    stretch_steps=0)
    assert read("launches_per_step.train", empty) is None
    assert program_spans.idle_by_phase(empty) is None
    # the window's steps need only the ring and the window
    assert len(program_spans.window_steps(empty)) == 2


def test_readers_find_nothing_without_the_ring(monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda: None)
    assert program_spans.window_steps(context()) is None
    assert program_spans.idle_by_phase(context()) is None


def test_readers_find_nothing_where_the_steps_left_the_ring(monkeypatch):
    # a third window step that the ring no longer holds
    monkeypatch.setattr(program_spans, "ring", lambda: list(RING))
    ctx = context(window={"t0": 0.0, "t1": 0.1, "steps": 3})
    assert program_spans.window_steps(ctx) is None
    # the device-only stretch's first step overwritten
    first = TIMELINE[0] * MS
    monkeypatch.setattr(program_spans, "ring", lambda: [
        s for s in RING if not first <= s.start < first + 10 * MS])
    assert program_spans.idle_by_phase(context()) is None


def test_idle_finds_nothing_where_the_stretches_share_no_clock(ring):
    ctx = context(timeline=trace.Trace(timeline_events(shift=-3.6e9)))
    assert program_spans.idle_by_phase(ctx) is None


def test_the_programs_own_ring_is_read():
    """Without a stand-in, the readers take the port's ring (or None from
    a port that has none)."""
    spans = program_spans.ring()
    assert spans is None or all(hasattr(s, "step") for s in spans)
