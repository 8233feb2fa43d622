"""The training step's own spans on one CUDA card: one traced run of a
benchmark cell, with every number its span readers rest on, and what the
spans cost.

    python3 scripts/profile_torch_spans.py [--workload pretrain_4f_b64] \
        [--seed 1234567891] [--seconds 30] [--out chiprun_out/spans]

  1. cost off — `with span(name)` with no profiler active, timed over
                 200 000 spans on the host (a microsecond figure).
  2. the run  — `perfbench/harness.py::run_cell` as `perfbench/run.py
                 --trace 1` runs it, its result line printed as that
                 command prints it. The context its readers got is kept,
                 and from it: the host's ms a step of each span over the
                 untraced window beside the benchmark's own clock of the
                 step call; each profiled step's launches; the clock
                 offset from the ring to the profiler (its spread, and how
                 far the placed spans' starts and ends lie from their
                 ranges); the device-only stretch's idle time by phase,
                 inside the steps and outside them; the idle gaps' names.
  3. cost on  — the host-and-device stretch (as the benchmark traces it)
                 of a second program, in turns with the spans' ranges
                 entered and not: the host's ms a step of each (the ring's
                 `egovlpv2.step`).

The card's name and power limit head the output; everything goes to
<out>/spans_<seed>.json as well.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not found"


def span_cost_us(n: int = 200_000) -> float:
    from egovlpv2_torch.utils.logging import Spans

    rec = Spans()
    span = rec.span
    best = None
    for _ in range(3):
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("egovlpv2.step.forward"):
                pass
        spent = time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        spent -= time.perf_counter_ns() - t
        best = spent if best is None else min(best, spent)
    return best / n / 1e3


def host_table(steps) -> dict:
    """Each span's host ms a step over `steps` (each a list of its spans),
    and the step's own time (its span less its children's)."""
    from perfbench.program_spans import STEP

    if not steps:
        return {}
    total = {}
    for step in steps:
        head = next(s for s in step if s.name == STEP)
        for s in step:
            total[s.name] = total.get(s.name, 0) + s.end - s.start
        children = sum(s.end - s.start for s in step if s.parent == head.id)
        total["(step self)"] = (total.get("(step self)", 0) + head.end
                                - head.start - children)
    return {k: v / 1e6 / len(steps) for k, v in total.items()}


def the_run(args) -> dict:
    from perfbench import harness, kinds, manifest, program_spans

    captured = {}
    reader = manifest.reader

    def capturing(root, metric):
        mod = reader(root, metric)

        class Kept:
            @staticmethod
            def read(ctx):
                captured["ctx"] = ctx
                return mod.read(ctx)

        return Kept

    harness.manifest.reader = capturing
    try:
        result = harness.run_cell(args.root, args.workload, args.seed,
                                  args.seconds, True, args.device,
                                  time.perf_counter())
    finally:
        harness.manifest.reader = reader
    ctx = captured["ctx"]
    spans = program_spans.ring()
    after = [s for s in spans if s.start > ctx.window["t1"] * 1e9]
    clock = program_spans.clock(ctx.trace, after)
    idle = program_spans.idle_by_phase(ctx)
    by_step = program_spans.by_step(after)
    linked = sorted({s.step for s in clock["spans"]}) if clock else []
    out = {"result": result,
           "host_ms": host_table(program_spans.window_steps(ctx, spans)),
           "host_ms_device_only_stretch": host_table(
               program_spans.timeline_steps(ctx, after, clock["spans"])
               if clock else None),
           "host_ms_host_and_device_stretch": host_table(
               [by_step[k] for k in linked]),
           "harness_host_ms_per_step": 1e3 * statistics.mean(ctx.spans),
           "window_steps": ctx.window["steps"],
           "launches": program_spans.launches_per_step(ctx.trace),
           "stretch_steps": ctx.stretch_steps,
           "timeline_s": ctx.timeline_s,
           "timeline_busy_ms": ctx.timeline.busy_us() / 1e3}
    if clock is not None:
        out["clock"] = {k: v for k, v in clock.items() if k != "spans"}
    if idle is not None:
        out["idle_ms_per_step"] = {
            k: v / 1e3 / ctx.stretch_steps for k, v in idle.items()
            if k != "offset"}
        phases = sum(idle[p] for p in program_spans.PHASES)
        out["idle_ms_per_step"]["in step, outside the phases"] = (
            idle["step"] - phases) / 1e3 / ctx.stretch_steps
        out["idle_ms_per_step"]["outside every step"] = (
            idle["all"] - idle["step"]) / 1e3 / ctx.stretch_steps
    out["idle_gaps"] = kinds.breakdown(ctx.timeline, ctx.trace)["idle_gaps"]
    return out


def cost_on(args, rounds: int = 3, count: int = 3) -> dict:
    """Host ms a step in the host-and-device stretch, ranges on and off."""
    from egovlpv2_torch.utils import logging as program_logging
    from perfbench import harness, inputs, trace
    from perfbench.program_spans import STEP

    cell = harness.Cell(args.root, args.workload)
    seeds = harness.Seeds(args.seed + 1)
    pool = inputs.make_pool(cell.cfg, cell.traffic, cell.rows, seeds.data,
                            args.device)
    prog = harness.Program(cell, seeds, args.device)
    batches = harness.device_batches(pool, args.device)
    prog.checked_steps(batches, cell.spec["checked_steps"])
    enabled = program_logging._profiler_enabled
    got = {"on": [], "off": []}
    at = cell.spec["checked_steps"]
    for r in range(rounds):
        for side in (("on", "off") if r % 2 == 0 else ("off", "on")):
            program_logging._profiler_enabled = (
                enabled if side == "on" else (lambda: False))
            mark = program_logging.SPANS.last
            try:
                with trace.Instrument():
                    tr = trace.profile(lambda: prog.steps(
                        batches, at, count=count), args.device == "cuda")
            finally:
                program_logging._profiler_enabled = enabled
            at += count
            steps = [s for s in program_logging.SPANS.records(mark)
                     if s.name == STEP]
            got[side] += [(s.end - s.start) / 1e6 for s in steps]
            names = {r.name for r in tr.ranges if r.name.startswith(
                "egovlpv2.")}
            assert (side == "on") == bool(names), (side, names)
    del prog, batches
    harness.free(args.device)
    return {k: {"median_ms": statistics.median(v), "steps_ms": v}
            for k, v in got.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="pretrain_4f_b64")
    p.add_argument("--seed", type=int, default=1234567891)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default="chiprun_out/spans")
    args = p.parse_args()
    args.root, args.device = ROOT, "cuda"

    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    report = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "workload": args.workload,
              "seed": args.seed, "span_cost_off_us": span_cost_us()}
    print(json.dumps({k: report[k] for k in list(report)}), flush=True)
    report["run"] = the_run(args)
    print(json.dumps(report["run"]["result"]), flush=True)
    print(json.dumps({k: v for k, v in report["run"].items()
                      if k != "result"}, indent=1), flush=True)
    report["cost_on"] = cost_on(args)
    print(json.dumps({"cost_on": report["cost_on"]}), flush=True)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    (out / f"spans_{args.seed}.json").write_text(json.dumps(report,
                                                            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
