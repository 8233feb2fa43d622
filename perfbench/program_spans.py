"""The program's own spans of the training step, as the per-layer readers
(`launches_per_step.train`, `graph_replay_share.train`) and
`scripts/profile_torch_spans.py` take them: the port's ring of host
spans (`egovlpv2_torch.utils.logging.SPANS`, `time.perf_counter_ns()`)
and the same spans as `record_function` ranges in the host-and-device
stretch (`ctx.trace`, microseconds on the profiler's clock).

The window: the steps whose `egovlpv2.step` starts inside the untraced
window's `t0`-`t1`; a reader of it finds nothing unless the ring holds
every one of them.

The clock: the host-and-device stretch holds each span twice, as its
range and as its ring entry; the median of (range start - ring start)
over the matched spans is the offset from the ring's clock to the
profiler's. The profiler exports times after a base that one process
keeps for all its sessions, so the same offset places the ring's spans of
the device-only stretch (`ctx.timeline`, profiled in the same process) on
that stretch's device timeline, where `idle_by_phase` cuts an eager
step's idle time at its phases. It checks that most of that stretch's
device activity falls inside the placed steps, and finds nothing where it
does not (a profiler whose sessions do not share the base).

Every function returns None where it has nothing to read: no trace, a
program without the ring (the ring came with these readers), or steps
that are not all in it.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "egovlpv2.step"
PREFIX = "egovlpv2."
# the phases of an eager step, as `idle_by_phase` (and
# `scripts/profile_torch_spans.py`) split it (the rest of a step is its own
# time and `egovlpv2.step.put`); a replayed step has none of them
PHASES = {
    "forward": ("egovlpv2.step.forward",),
    "backward": ("egovlpv2.step.backward",),
    "optimizer": ("egovlpv2.step.zero_grad", "egovlpv2.step.optimizer"),
}


def ring() -> Optional[list]:
    """The program's finished spans, oldest first, or None where the
    program keeps no ring."""
    try:
        from egovlpv2_torch.utils import logging as program_logging
    except ImportError:
        return None
    spans = getattr(program_logging, "SPANS", None)
    return spans.records() if spans is not None else None


def by_step(spans: Sequence) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for s in spans:
        out.setdefault(s.step, []).append(s)
    return out


def window_steps(ctx, spans=None) -> Optional[List[list]]:
    """Each step of the untraced window as its list of spans, or None
    unless the ring holds all of the window's steps."""
    spans = ring() if spans is None else spans
    w = getattr(ctx, "window", None)
    if not spans or not w:
        return None
    t0, t1 = w["t0"] * 1e9, w["t1"] * 1e9
    steps = by_step(spans)
    inside = [steps[s.step] for s in spans
              if s.name == STEP and t0 <= s.start <= t1]
    return inside if len(inside) == w["steps"] else None


# ---- the traced stretches

def launches_per_step(tr) -> Optional[List[int]]:
    """Each `egovlpv2.step` range's launches that put work on the device
    (kernels, copies, sets: a runtime or driver call whose correlation id
    one of the trace's device events carries), on any thread (the
    backward launches from the autograd engine's), by the launch's time."""
    steps = [r for r in tr.ranges if r.name == STEP] if tr is not None else []
    if not steps:
        return None
    times = sorted(ts for ls in tr.launches.values() for ts, c in ls
                   if c in tr.by_corr)
    if not times:
        return None
    return [bisect.bisect_right(times, r.end) - bisect.bisect_left(times, r.ts)
            for r in steps]


def match(tr, spans) -> Optional[Tuple[list, list]]:
    """The run of ring spans that the trace's `egovlpv2.` ranges record,
    as (ranges, spans) paired in order: of the runs with the same names,
    the one whose start differences spread least (of equal ones the
    latest: the profiled stretch is the last the ring holds)."""
    ranges = sorted((r for r in tr.ranges if r.name.startswith(PREFIX)),
                    key=lambda r: r.ts)
    if not ranges or not spans:
        return None
    names = [r.name for r in ranges]
    best, best_spread = None, None
    for k in range(len(spans) - len(ranges) + 1):
        run = spans[k:k + len(ranges)]
        if [s.name for s in run] != names:
            continue
        diffs = [r.ts - s.start / 1e3 for r, s in zip(ranges, run)]
        spread = max(diffs) - min(diffs)
        if best_spread is None or spread <= best_spread:
            best, best_spread = run, spread
    return (ranges, best) if best is not None else None


def clock(tr, spans) -> Optional[dict]:
    """The offset (microseconds) from the ring's clock to the profiler's,
    from the matched spans, with the spread of their differences and how
    far the placed ring spans' starts and ends lie from their ranges'."""
    found = match(tr, spans) if tr is not None else None
    if found is None:
        return None
    ranges, run = found
    diffs = [r.ts - s.start / 1e3 for r, s in zip(ranges, run)]
    offset = statistics.median(diffs)
    q = (statistics.quantiles(diffs, n=4) if len(diffs) > 1
         else [diffs[0]] * 3)
    return {
        "offset_us": offset, "spread_us": q[2] - q[0],
        "range_us": max(diffs) - min(diffs), "matched": len(run),
        "start_gap_us": statistics.median(
            abs(r.ts - (s.start / 1e3 + offset)) for r, s in zip(ranges, run)),
        "end_gap_us": statistics.median(
            abs(r.end - (s.end / 1e3 + offset)) for r, s in zip(ranges, run)),
        "spans": run}


def timeline_steps(ctx, spans, matched) -> Optional[List[list]]:
    """The device-only stretch's steps: those the ring holds (after the
    window) before the host-and-device stretch's first, as many as the
    stretch profiled."""
    first = min(s.start for s in matched if s.name == STEP)
    steps = by_step(spans)
    found = [steps[s.step] for s in spans if s.name == STEP
             and s.start < first]
    return found if len(found) == ctx.stretch_steps else None


def busy_within(busy, a: float, b: float) -> float:
    """Microseconds of the merged `busy` intervals inside [a, b]."""
    i = max(bisect.bisect_right(busy, (a, float("inf"))) - 1, 0)
    total = 0.0
    for lo, hi in busy[i:]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


def idle_by_phase(ctx, spans=None) -> Optional[dict]:
    """The device-only stretch's idle microseconds inside each phase's
    placed spans, inside the steps and in all, summed over its steps."""
    spans = ring() if spans is None else spans
    tr, tl = getattr(ctx, "trace", None), getattr(ctx, "timeline", None)
    w = getattr(ctx, "window", None)
    if not spans or not w or tr is None or tl is None or not tl.device:
        return None
    spans = [s for s in spans if s.start > w["t1"] * 1e9]
    c = clock(tr, spans)
    if c is None:
        return None
    steps = timeline_steps(ctx, spans, c["spans"])
    if steps is None:
        return None
    off = c["offset_us"]
    busy = tl.busy_intervals()
    heads = [next(s for s in step if s.name == STEP) for step in steps]

    def placed(s) -> Tuple[float, float]:
        return s.start / 1e3 + off, s.end / 1e3 + off

    # most of the stretch's device activity lies inside its placed steps
    # (the rest is the tail of the last step and the loss reads after it)
    if sum(busy_within(busy, *placed(h)) for h in heads) < 0.5 * tl.busy_us():
        return None

    def idle(s) -> float:
        a, b = placed(s)
        return (b - a) - busy_within(busy, a, b)

    out = {p: 0.0 for p in PHASES}
    for step in steps:
        for p, names in PHASES.items():
            found = [s for s in step if s.name in names]
            if {s.name for s in found} != set(names):
                return None
            out[p] += sum(idle(s) for s in found)
    out["step"] = sum(idle(h) for h in heads)
    out["all"] = ctx.timeline_s * 1e6 - tl.busy_us()
    out["offset"] = c
    return out
