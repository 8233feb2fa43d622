"""Hyperparameter grid sweep for the EgoMQ head (and any dict-metric task);
a copy of `egovlpv2_tpu/downstream/sweep.py` over the port's `run_egomq`.

Capability-parity target: the reference greps per-config result files for the
best Average-mAP after a shell-loop grid over (batch_size, lr, step, gamma)
(`EgoMQ/scripts/train_infer_eval_ego_nce.sh:38-56` +
`EgoMQ/find_best_parameters.py`). The published 12.23 avg mAP is the max over
that grid, so reproducing the protocol requires this harness.

Here the sweep is a plain Python driver: it calls a run function per config,
records every result to `sweep_results.json` as it goes (crash-safe, like the
reference's per-config .txt files), and returns the argmax by a chosen key.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

# The reference grid (train_infer_eval_ego_nce.sh:38-56).
REFERENCE_EGOMQ_GRID: Dict[str, Sequence[Any]] = {
    "batch_size": (32, 16, 8),
    "lr": (1e-4, 5e-4, 5e-5, 1e-5),
    "step_size": (15, 30, 5),
    "gamma": (0.05, 0.1, 0.5, 0.25),
}


def grid_configs(grid: Mapping[str, Sequence[Any]]):
    """Yield {name: value} dicts in the reference's nested-loop order."""
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, values))


def grid_sweep(
    run_fn: Callable[..., Dict[str, float]],
    grid: Mapping[str, Sequence[Any]],
    *,
    metric_key: str = "mAP_avg",
    out_path: Optional[str] = None,
    higher_is_better: bool = True,
) -> Tuple[Dict[str, Any], Dict[str, float], list]:
    """Run `run_fn(**config)` for every grid point; return the best.

    Returns (best_config, best_metrics, all_results). `all_results` is a list
    of {"config": ..., "metrics": ...} in run order; it is flushed to
    `out_path` after every run so partial sweeps are recoverable
    (find_best_parameters.py scans the same way).
    """
    results = []
    best_cfg: Optional[Dict[str, Any]] = None
    best_metrics: Optional[Dict[str, float]] = None
    sign = 1.0 if higher_is_better else -1.0
    best_score = -float("inf")
    for cfg in grid_configs(grid):
        metrics = run_fn(**cfg)
        results.append({"config": cfg, "metrics": metrics})
        score = sign * float(metrics[metric_key])
        if score > best_score:
            best_score, best_cfg, best_metrics = score, cfg, metrics
        if out_path:
            payload = {
                "grid": {k: list(v) for k, v in grid.items()},
                "metric_key": metric_key,
                "results": results,
                "best": {"config": best_cfg, "metrics": best_metrics},
            }
            tmp = out_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2)
            os.replace(tmp, out_path)
    assert best_cfg is not None, "empty grid"
    return best_cfg, best_metrics, results


def run_egomq_sweep(
    clip_anno: str,
    feature_path: str,
    out_dir: str,
    grid: Optional[Mapping[str, Sequence[Any]]] = None,
    run_fn: Optional[Callable[..., Dict[str, float]]] = None,
    **fixed_kwargs,
) -> Dict[str, Any]:
    """Grid-search the VSGN head over (batch_size, lr, step_size, gamma).

    `fixed_kwargs` (epochs, temporal_scale, ...) are passed to every run.
    Writes `<out_dir>/sweep_results.json`; returns its 'best' entry.
    """
    from egovlpv2_torch.tasks.orchestrators import run_egomq

    grid = dict(grid if grid is not None else REFERENCE_EGOMQ_GRID)
    base_run = run_fn if run_fn is not None else run_egomq

    def one(**cfg):
        sub = os.path.join(
            out_dir, "_".join(f"{k}={v}" for k, v in sorted(cfg.items())))
        os.makedirs(sub, exist_ok=True)
        return base_run(clip_anno=clip_anno, feature_path=feature_path,
                        out_dir=sub, **cfg, **fixed_kwargs)

    os.makedirs(out_dir, exist_ok=True)
    best_cfg, best_metrics, _ = grid_sweep(
        one, grid, metric_key="mAP_avg",
        out_path=os.path.join(out_dir, "sweep_results.json"),
    )
    return {"config": best_cfg, "metrics": best_metrics}
