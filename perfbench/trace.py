"""The benchmark's tracing: named ranges around the calls into the hand-
kernel ops, `torch.profiler` over a stretch of steps, and the parsed trace
that the per-layer readers take their numbers from.

`Instrument` wraps the port's op entry points while the host-and-device
stretch is traced: every call of `ops.divided.divided_attention` (as
`models/video.py` calls it), of `ops.layernorm.layernorm` and of
`ops.flash.flash_attention` (K9, as `ops/attention.py::attend` calls it)
runs inside a `record_function` range whose name carries the call's
shapes, `perfbench.<op>|<shape fields>`. The ranges name the idle gaps of that
stretch (`kinds.breakdown`), and the tests hold the benchmark's table of
the step's calls (`bounds.pretrain_calls`) against them: a range's
backward is the autograd nodes whose sequence numbers the ops inside it
recorded. No reader credits device time to a range: the readers take a
kernel family's time by kernel name (`kinds.FAMILIES`), which a replayed
CUDA graph, whose kernels all carry its one launch's correlation and run
under no operator, leaves as it is.

`Trace` is the profile of one stretch as plain lists: device events
(kernels, copies, sets), host ranges (operators, annotations, autograd
nodes) and each thread's launches with their correlation ids. A traced
run profiles two stretches: one of the device alone, for the busy time,
the idle share, the time by kind and the families' times (tracing the
host's operators as well slows a host-paced step about twofold), and one
of host and device, for the launches, the idle gaps' names and the clock
of the program's spans.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

import torch

STRETCH = "perfbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


class Range:
    __slots__ = ("name", "ts", "end", "tid", "seq")

    def __init__(self, name, ts, end, tid, seq):
        self.name, self.ts, self.end, self.tid, self.seq = (name, ts, end,
                                                             tid, seq)


class Trace:
    """One profiled stretch; times in microseconds on the host's clock."""

    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[float, float, str, object]] = []
        self.ranges: List[Range] = []
        launches = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if cat in DEVICE_CATS:
                self.device.append((ts, end, e.get("name", ""),
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and args.get("correlation") is not None:
                launches[e.get("tid")].append((ts, args["correlation"]))
            elif cat in HOST_CATS:
                self.ranges.append(Range(e.get("name", ""), ts, end,
                                         e.get("tid"),
                                         args.get("Sequence number")))
        self.device.sort(key=lambda ev: (ev[0], ev[1]))
        self.ranges.sort(key=lambda r: r.ts)
        self.by_tid: Dict[object, List[Range]] = defaultdict(list)
        for r in self.ranges:
            self.by_tid[r.tid].append(r)
        self.tid_ts = {tid: [r.ts for r in rs]
                       for tid, rs in self.by_tid.items()}
        self.launches = {tid: sorted(v) for tid, v in launches.items()}
        self.by_corr: Dict[object, List[int]] = defaultdict(list)
        for i, ev in enumerate(self.device):
            self.by_corr[ev[3]].append(i)

    # ---- links

    def named(self, prefix: str) -> List[Range]:
        return [r for r in self.ranges if r.name.startswith(prefix)]

    def inside(self, outer: Range) -> List[Range]:
        """Ranges on `outer`'s thread that lie inside it."""
        rs, ts = self.by_tid[outer.tid], self.tid_ts[outer.tid]
        lo = bisect.bisect_left(ts, outer.ts)
        hi = bisect.bisect_right(ts, outer.end)
        return [r for r in rs[lo:hi] if r is not outer and r.end <= outer.end]

    def backward_of(self, outer: Range) -> List[Range]:
        """The autograd nodes run for the ops recorded inside `outer`."""
        seqs = {r.seq for r in self.inside(outer) if r.seq is not None
                and r.seq >= 0}
        if outer.seq is not None and outer.seq >= 0:
            seqs.add(outer.seq)
        return [r for r in self.backward_nodes() if r.seq in seqs]

    def backward_nodes(self) -> List[Range]:
        if not hasattr(self, "_bwd"):
            self._bwd = [r for r in self.ranges
                         if r.name.startswith(BACKWARD_PREFIX)
                         and r.seq is not None]
        return self._bwd

    # ---- the timeline

    def stretch(self) -> Optional[Range]:
        found = self.named(STRETCH)
        return found[0] if found else None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity (inside the stretch's range where
        the host was traced), merged."""
        s = self.stretch()
        merged: List[List[float]] = []
        for ts, end, _, _ in self.device:
            if s is not None:
                ts, end = max(ts, s.ts), min(end, s.end)
            if end <= ts:
                continue
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        s = self.stretch()
        gaps, at = [], s.ts
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = b
        if s.end > at:
            gaps.append((at, s.end))
        return gaps

    def open_during(self, a: float, b: float) -> str:
        """What the host was doing from `a` to `b`: the host range that
        overlaps the interval most (of equal overlaps the latest started,
        the innermost), the stretch's own range aside."""
        best, best_key = None, None
        for r in self.ranges:
            overlap = min(r.end, b) - max(r.ts, a)
            if overlap <= 0 or r.name == STRETCH:
                continue
            key = (overlap, r.ts)
            if best_key is None or key > best_key:
                best, best_key = r, key
        return best.name if best is not None else "(no host range)"


def load_chrome(path: str) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"])


def profile(fn, cuda: bool = True) -> Trace:
    """Runs `fn()` under `torch.profiler` (host and, with `cuda`, device),
    inside the stretch's range, then synchronises; returns the parsed
    trace. The raw trace goes to a temporary file in TMPDIR and is
    deleted."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(STRETCH):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_chrome(path)
    finally:
        os.unlink(path)


def profile_device(fn, cuda: bool = True) -> Tuple[Trace, float]:
    """Runs `fn()` after a synchronisation under `torch.profiler` tracing
    the device alone, which slows the host far less than tracing its
    operators too, and synchronises; returns the trace and the host's
    seconds from before `fn` to after the final synchronisation."""
    import time

    from torch.profiler import ProfilerActivity, profile as torch_profile

    if not cuda:
        t = time.perf_counter()
        fn()
        return Trace([]), time.perf_counter() - t
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_chrome(path), seconds
    finally:
        os.unlink(path)


def call_name(op: str, **shape) -> str:
    return "perfbench." + op + "|" + "|".join(
        f"{k}={v}" for k, v in shape.items())


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@contextmanager
def Instrument():
    """Wraps the port's divided attention (as the video tower calls it),
    LayerNorm and fused attention (as `attend` calls it) entry points in
    named ranges for as long as the context lasts."""
    from egovlpv2_torch.models import video
    from egovlpv2_torch.ops import attention
    from egovlpv2_torch.ops import layernorm as ln_module

    divided, layernorm = video.divided_attention, ln_module.layernorm
    fused = attention.flash_attention

    def divided_ranged(qkv, *, scale, axis, num_frames):
        b, s, _, h, dh = qkv.shape
        with torch.profiler.record_function(call_name(
                "divided_attn", b=b, s=s, h=h, dh=dh, frames=num_frames,
                axis=axis, dtype=_dtype(qkv))):
            return divided(qkv, scale=scale, axis=axis,
                           num_frames=num_frames)

    def layernorm_ranged(x, scale, bias, *, eps=1e-5):
        with torch.profiler.record_function(call_name(
                "layernorm", rows=x.numel() // x.shape[-1], d=x.shape[-1],
                dtype=_dtype(x))):
            return layernorm(x, scale, bias, eps=eps)

    def fused_ranged(q, k, v, *, scale, bias=None, **kw):
        sq, dh = q.shape[-2:]
        h = q.shape[-3] if q.dim() > 2 else 1
        with torch.profiler.record_function(call_name(
                "fused_attn", b=q.numel() // (h * sq * dh), h=h, sq=sq,
                sk=k.shape[-2], dh=dh, dtype=_dtype(q),
                causal=bool(kw.get("causal", False)),
                bias=bias is not None)):
            return fused(q, k, v, scale=scale, bias=bias, **kw)

    video.divided_attention = divided_ranged
    ln_module.layernorm = layernorm_ranged
    attention.flash_attention = fused_ranged
    try:
        yield
    finally:
        video.divided_attention = divided
        ln_module.layernorm = layernorm
        attention.flash_attention = fused
