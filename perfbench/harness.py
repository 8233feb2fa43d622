"""One run of one cell: set-up, the checked first steps, the timed window,
the traced stretch, and the comparison with the reference.

Set-up builds the port's training step from the pieces that the cell's
task file names (`perfbench/tasks/<task>.py`: the configuration's
loader, the model, the optimizer, the step maker) and the port's
`parallel.mesh.train_generators`, fills the parameters from the seed on
the device by the task's weight rules, and draws the pool of input
batches on the device. The first steps, which build and warm every
kernel the window uses, go through the window's own call on the pool's
first batches: their losses, the first gradient (from AdamW's first
moment after one step) and the parameters' change over them are the
program's readings. The same object then runs the window: step i-1's
loss is read after step i is launched, nothing is drawn or copied from
the host, and one synchronisation closes it. A traced run then profiles
a short stretch of further steps. Last, the program's state is freed and
the reference that the task names (`perfbench/reference/<REFERENCE>.py`)
repeats the first steps in float64 from the same seed. Nothing here
names a model.
"""

from __future__ import annotations

import gc
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import compare, inputs, kinds, manifest, trace
from perfbench.reference import train as reference
from perfbench.weights import make_weights


class Seeds:
    """Independent seeds for the weights, the inputs and the dropout (and
    mining) generator, derived from the run's seed."""

    def __init__(self, seed: int):
        state = np.random.SeedSequence(seed).generate_state(3, np.uint64)
        self.weights, self.data, self.dropout = (int(x) & (2 ** 63 - 1)
                                                 for x in state)


class Cell:
    """A cell's configuration, traffic, limits and task, read by name."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = manifest.load(root)
        self.entry = manifest.workload(self.bench, name)
        self.config_file = self.root / manifest.config(
            self.bench, self.entry["config"])["file"]
        with open(self.config_file) as f:
            self.cfg = json.load(f)
        self.traffic = manifest.traffic(root, self.entry["traffic"])
        self.spec = manifest.cell(root, name)
        self.task = manifest.task(root, self.cfg["_task"])
        self.chips = self.entry["chips"]
        self.rows = self.cfg["global_batch_size"] // self.chips

    def program_config(self):
        return self.task.program_config(str(self.config_file))

    def weights(self, shapes, seed: int, device) -> Dict[str, torch.Tensor]:
        return make_weights(shapes, seed, device, self.task.init_kind)


class Program:
    """The port's training step, its model and optimizer, on `device`."""

    def __init__(self, cell: Cell, seeds: Seeds, device):
        from egovlpv2_torch.parallel.mesh import train_generators

        cfg = cell.program_config()
        self.cell = cell
        self.device = torch.device(device)
        self.seeds = seeds
        self.model = cell.task.build_model(cfg, self.device)
        self.shapes = {n: tuple(p.shape)
                       for n, p in self.model.named_parameters()}
        weights = cell.weights(self.shapes, seeds.weights, self.device)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(weights[n])
        del weights
        self.optimizer, scheduler = cell.task.make_optimizer(cfg, self.model)
        generator, mining = train_generators(self.device, seeds.dropout)
        self.step = cell.task.make_step(self.model, cfg, self.optimizer,
                                        scheduler, generator, mining)

    @torch.no_grad()
    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient as AdamW took it on its first step: its
        first moment over 1 - beta1 (0 where the optimizer kept none), in
        host memory until the reference has run."""
        beta1 = {id(p): g["betas"][0] for g in self.optimizer.param_groups
                 for p in g["params"]}
        out = {}
        for n, p in self.model.named_parameters():
            m = self.optimizer.state.get(p, {}).get("exp_avg")
            out[n] = (torch.zeros_like(p) if m is None
                      else m / (1 - beta1[id(p)])).cpu()
        return out

    @torch.no_grad()
    def change(self) -> Dict[str, torch.Tensor]:
        """Each leaf's change from the seeded weights (drawn again), kept
        in host memory until the reference has run."""
        start = self.cell.weights(self.shapes, self.seeds.weights,
                                  self.device)
        return {n: (p - start[n]).cpu()
                for n, p in self.model.named_parameters()}

    def checked_steps(self, batches, n: int) -> dict:
        losses, grads = [], None
        for i in range(n):
            metrics = self.step(batches[i])
            losses.append({k: float(v) for k, v in metrics.items()
                           if k.startswith("loss_")})
            if i == 0:
                grads = self.first_gradient()
        return {"names": list(self.shapes), "losses": losses,
                "grads": grads, "change": self.change()}

    def steps(self, batches, first: int, seconds: Optional[float] = None,
              count: Optional[int] = None, spans: Optional[list] = None
              ) -> dict:
        """Steps over `batches` from index `first`, for `seconds` or `count`
        steps: step i-1's loss is read after step i is launched, one
        synchronisation at the end. `spans` gets each call's host seconds."""
        sync = self.device.type == "cuda"
        i, prev, losses, reads = first, None, [], []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            metrics = self.step(batches[i % len(batches)])
            if spans is not None:
                spans.append(time.perf_counter() - a)
            i += 1
            if prev is not None:
                losses.append(float(prev))
                reads.append(time.perf_counter())
            prev = metrics["loss_total"]
            done = i - first
            if (count is not None and done >= count) or (
                    seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        losses.append(float(prev))
        if sync:
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        reads.append(t1)
        return {"t0": t0, "t1": t1, "steps": i - first, "losses": losses,
                "reads": reads, "next": i}


def reference_readings(cell: Cell, seeds: Seeds, shapes, batches, n: int,
                       device, precision: str = "float64") -> dict:
    weights = cell.weights(shapes, seeds.weights, device)
    generator = torch.Generator(device=device).manual_seed(seeds.dropout)
    return reference.readings(
        cell.cfg, manifest.reference(cell.root, cell.task.REFERENCE),
        weights, batches, generator, n, precision, device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_batches(pool: List[Dict[str, torch.Tensor]], device) -> list:
    """The pool as the port's `DeviceBatch`es, already on the device (its
    step takes them as they are)."""
    from egovlpv2_torch.data.loader import DeviceBatch

    out = []
    for b in pool:
        db = DeviceBatch(b)
        db.device = torch.device(device)
        out.append(db)
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> dict:
    """One run; returns the result line's object, the compared numbers
    under "checks"."""
    cell = Cell(root, name)
    seeds = Seeds(seed)
    cuda = torch.device(device).type == "cuda"
    n_check = cell.spec["checked_steps"]
    pool = inputs.make_pool(cell.cfg, cell.traffic, cell.rows, seeds.data,
                            device)
    prog = Program(cell, seeds, device)
    batches = device_batches(pool, device)
    readings = prog.checked_steps(batches, n_check)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans: List[float] = []
    window = prog.steps(batches, n_check, seconds=seconds,
                        spans=spans if traced else None)
    setup_s = window["t0"] - t_start
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    # the window's peak of the allocator's reserved segments: a replayed
    # step's working set lies in its graph's private pool, whose blocks
    # count as allocated only while a capture or an eager step holds them
    reserved_window = torch.cuda.max_memory_reserved() if cuda else 0
    stretch = timeline = None
    stretch_steps, timeline_s = 0, 0.0
    if traced:
        stretch_steps = cell.spec["profiled_steps"]
        timeline, timeline_s = trace.profile_device(lambda: prog.steps(
            batches, window["next"], count=stretch_steps), cuda)
        with trace.Instrument():
            stretch = trace.profile(lambda: prog.steps(
                batches, window["next"] + stretch_steps,
                count=stretch_steps), cuda)
    peak = max(peak_setup, peak_window,
               torch.cuda.max_memory_allocated() if cuda else 0)
    failed = sum(1 for x in window["losses"] if not math.isfinite(x))
    shapes = prog.shapes
    del prog, batches
    free(device)

    ref = reference_readings(cell, seeds, shapes, pool, n_check, device)
    numbers = compare.gaps(readings, ref)
    limits = cell.spec["limits"]
    correct = compare.judge(numbers, limits) and failed == 0

    # what the metric readers read: host clocks, counts, shapes, traces
    ctx = SimpleNamespace(
        cfg=cell.cfg, chips=cell.chips, rows=cell.rows, setup_s=setup_s,
        window=window, spans=spans,
        flops=cell.task.step_flops(cell.cfg, cell.rows, cell.traffic),
        calls=cell.task.step_calls(cell.cfg, cell.rows, cell.traffic),
        reserved_window_bytes=reserved_window, trace=stretch,
        timeline=timeline, timeline_s=timeline_s,
        stretch_steps=stretch_steps)
    metrics = {}
    for m in manifest.metrics_of(cell.bench, name, traced):
        value = manifest.reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window["steps"],
              "failed": failed, "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = timeline.busy_us() / 1e6
        dev["window_s"] = timeline_s
        result["breakdown"] = kinds.breakdown(timeline, stretch)
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits.items()}
    return result
