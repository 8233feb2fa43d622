"""The numbers a training run's `correct` is decided by, each a gap between
the program's reading and the reference's on the same weights, inputs and
dropout masks; a cell's file names those it is held to:

  loss_gap        the largest, over the checked steps, of |L_program -
                  L_ref| / |L_ref| of the total loss; loss_<part>_gap the
                  same of one objective (EgoNCE, MLM, ITM);
  grad_gap        the worst leaf's |‖g_program‖ - ‖g_ref‖| over the larger
                  of ‖g_ref‖ of that leaf and of the median leaf, g the
                  first step's gradient as the optimizer took it;
                  grad_gap_median the median leaf's, grad_gap_mean the
                  mean over the leaves;
  delta_gap       the same of the parameters' change over the checked
                  steps (as far as the next step keeps it);
                  delta_gap_median, delta_gap_mean as above.

Leaves and elements left out, by a rule on the reference's first gradient
(the median leaf is the median over the leaves whose reference gradient is
not zero, by norm and by root mean square element): a leaf whose gradient
norm is under a thousandth of the median leaf's, and in the others an
element whose gradient is under a thousandth of the median leaf's root
mean square element. Their gradient is nought but for rounding (a key's
bias under softmax, the time attention's qkv at its identity start, whose
output LayerNorm removes), a larger rounding in bfloat16 than in float64,
and Adam moves them by rounding alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

FLOOR = 1e-3


def _gaps(prog: List[float], ref: List[float]) -> List[float]:
    floor = statistics.median(ref)
    out = []
    for p, r in zip(prog, ref):
        denom = max(r, floor)
        if not math.isfinite(p):
            out.append(math.inf)
        elif denom > 0:
            out.append(abs(p - r) / denom)
        else:
            out.append(0.0 if p == r else math.inf)
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def _loss_gaps(program: List[dict], reference: List[dict]
               ) -> Dict[str, float]:
    out = {}
    for key in reference[0]:
        name = "loss_gap" if key == "loss_total" else f"{key}_gap"
        gaps = []
        for p, r in zip(program, reference):
            v = p.get(key, math.nan)
            gaps.append(abs(v - r[key]) / abs(r[key]) if math.isfinite(v)
                        else math.inf)
        out[name] = max(gaps)
    return out


def kept(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """name -> mask of the elements compared, for the leaves compared."""
    norms = {n: _norm(g) for n, g in grads.items()}
    live = [n for n, v in norms.items() if v > 0]
    med = statistics.median(norms[n] for n in live)
    rms = statistics.median(norms[n] / math.sqrt(grads[n].numel())
                            for n in live)
    out = {}
    for n, g in grads.items():
        if norms[n] < FLOOR * med:
            continue
        keep = g.abs() >= FLOOR * rms
        if bool(keep.any()):
            out[n] = keep
    return out


@torch.no_grad()
def gaps(program: dict, reference: dict) -> Dict[str, float]:
    """`program` and `reference`: {"names", "losses" (a dict a step),
    "grads" and "change" (name -> tensor, any device)}."""
    if program["names"] != reference["names"]:
        raise ValueError("the program's parameters are not the reference's")
    out = _loss_gaps(program["losses"], reference["losses"])
    masks = kept(reference["grads"])
    for key, name in (("grads", "grad_gap"), ("change", "delta_gap")):
        prog, ref = [], []
        for n, keep in masks.items():
            ref.append(_norm(reference[key][n][keep]))
            prog.append(_norm(program[key][n].to(keep.device)[keep]))
        leaf = _gaps(prog, ref)
        out[name] = max(leaf)
        out[name + "_median"] = statistics.median(leaf)
        out[name + "_mean"] = sum(leaf) / len(leaf)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a non-finite number fails)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
