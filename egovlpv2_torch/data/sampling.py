"""Temporal frame samplers (host-side numpy): the port's copy of
`egovlpv2_tpu/data/sampling.py`.

Capability-parity target: `EgoVLPv2/base/base_dataset.py:180-224`
(sample_frames / sample_frames_start_end / sample_frames_clips): split the
frame range into `num_frames` intervals; train picks a random frame per
interval, eval the interval midpoint. RNG is injected for determinism.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _intervals(start: int, stop: int, n: int) -> List[tuple]:
    pts = np.linspace(start=start, stop=stop, num=n + 1).astype(int)
    return [(pts[i], pts[i + 1] - 1) for i in range(n)]


def sample_frames(
    num_frames: int,
    vlen: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    acc = min(num_frames, vlen)
    ranges = _intervals(0, vlen, acc)
    if sample == "rand":
        rng = rng or np.random.default_rng()
        # random.choice(range(lo, hi)) excludes hi; degenerate lo==hi would
        # raise in the reference — mirror by clamping to at least one choice.
        return [int(rng.integers(lo, max(hi, lo + 1))) for lo, hi in ranges]
    if fix_start is not None:
        return [lo + fix_start for lo, _ in ranges]
    if sample == "uniform":
        return [(lo + hi) // 2 for lo, hi in ranges]
    raise NotImplementedError(sample)


def sample_frames_start_end(
    num_frames: int,
    start: int,
    end: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    # NOTE: the reference clamps the count by `end` (base_dataset.py:210),
    # i.e. acc_samples = min(num_frames, end) — replicated verbatim.
    acc = min(num_frames, end)
    ranges = _intervals(start, end, acc)
    if sample == "rand":
        rng = rng or np.random.default_rng()
        return [int(rng.integers(lo, max(hi, lo + 1))) for lo, hi in ranges]
    if fix_start is not None:
        return [lo + fix_start for lo, _ in ranges]
    if sample == "uniform":
        return [(lo + hi) // 2 for lo, hi in ranges]
    raise NotImplementedError(sample)


def sliding_window_fix_starts(
    vlen: int, num_frames: int, stride: int
) -> List[int]:
    """Test-time sliding-window expansion offsets.

    Mirrors `_fix_temporal_samples` (base_dataset.py:82-89): each video
    expands into one entry per fix_start in
    arange(0, vlen // (min(vlen, num_frames) + 1), stride); every window
    shifts the per-interval sampled frame by its fix_start. Deviation: the
    reference's arange can be empty for very short videos (pandas explode
    then yields a NaN fix_start); here short videos keep one fix_start=0
    window instead.
    """
    acc = min(int(vlen), int(num_frames))
    upper = int(vlen / (acc + 1))
    return list(range(0, max(upper, 1), max(int(stride), 1)))


def sample_frames_clips(start: int, end: int, vlen: int, acc_samples: int) -> List[int]:
    """Midpoint sampling within [start, end] (base_dataset.py:197-207)."""
    start = max(0, start)
    end = min(vlen, end)
    ranges = _intervals(start, end, int(acc_samples))
    return [(lo + hi) // 2 for lo, hi in ranges]
