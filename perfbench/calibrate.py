#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, on the chip at
the cell's own size, in one process for many seeds:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3]

For each seed the program's checked steps against the float64 reference
(the lower reading); for each control seed the reference computed with
its matrix products in float8 (e4m3 operands and results, e5m2
gradients) put in the program's place (the control); for each fault seed the program with half of every batch left
out, the loss a mean over the rest. One JSON line each, with the seconds
the reference took. A step that leaves its state unchanged reads 1 on
grad_gap and delta_gap by their definition and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextmanager
def half_batch():
    """The port's step sees the first half of every batch's rows."""
    from egovlpv2_torch.train import step as step_module

    put = step_module.batch_to_device

    def halved(batch, device):
        full = put(batch, device)
        return {k: v[: v.shape[0] // 2] for k, v in full.items()}

    step_module.batch_to_device = halved
    try:
        yield
    finally:
        step_module.batch_to_device = put


def readings(cell, seed: int, device, kind: str) -> dict:
    from perfbench import compare, harness, inputs

    seeds = harness.Seeds(seed)
    n = cell.spec["checked_steps"]
    pool = inputs.make_pool(cell.cfg, cell.traffic, cell.rows, seeds.data,
                            device)
    prog = harness.Program(cell, seeds, device)
    shapes = prog.shapes
    if kind == "control":
        del prog
        harness.free(device)
        got = harness.reference_readings(cell, seeds, shapes, pool, n,
                                          device, "fp8")
    elif kind == "fault_half_batch":
        with half_batch():
            got = prog.checked_steps(harness.device_batches(pool, device), n)
        del prog
    else:
        got = prog.checked_steps(harness.device_batches(pool, device), n)
        del prog
    harness.free(device)
    t = time.perf_counter()
    ref = harness.reference_readings(cell, seeds, shapes, pool, n, device)
    seconds = time.perf_counter() - t
    out = {"kind": kind, "seed": seed, **compare.gaps(got, ref),
           "losses": [s["loss_total"] for s in got["losses"]],
           "ref_losses": [s["loss_total"] for s in ref["losses"]],
           "reference_s": seconds}
    del got, ref, pool
    harness.free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.Cell(ROOT, args.workload)
    plan = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, "fault_half_batch") for s in args.fault_seeds])
    for seed, kind in plan:
        print(json.dumps(readings(cell, seed, args.device, kind)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
