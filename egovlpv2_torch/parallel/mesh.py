"""Data parallel's batch and generators (counterpart of what
`egovlpv2_tpu/parallel/mesh.py` does for the `data` axis): each rank feeds
its contiguous rows of the global batch, draws its own dropout masks and
mines the same ITM pairs as every other rank.

`shard_batch` assembles a global array from each process's rows on the
TPU; here a rank keeps its rows (`local_rows`), which go to its device
through the port's one `DevicePut` (`train/step.py::batch_to_device`), and
the step gathers what the global loss needs (`parallel/collectives.py`).
`make_mesh`, `param_sharding` / `MODEL_PARTITION_RULES`, `shard_params`,
`replicate` and `_put_global` are GSPMD's placement of parameters over a
`model` axis: every rank here holds the whole model, which fits one H100.
`host_state`, the state rank 0 saves, is `train/checkpoint.py::
train_state`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from egovlpv2_torch.parallel.distributed import rank, world_size


def local_batch_size(global_batch_size: int) -> int:
    """The rows this rank feeds (global // world size)."""
    world = world_size()
    if global_batch_size % world:
        raise ValueError(f"global_batch_size {global_batch_size} not "
                         f"divisible by the {world} processes")
    return global_batch_size // world


def local_rows(batch: Dict, global_batch_size: int) -> Dict:
    """This rank's contiguous rows of a global host batch (every array
    sliced on its first axis); the batch itself in one process."""
    n = local_batch_size(global_batch_size)
    if n == global_batch_size:
        return batch
    lo = rank() * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


# apart from one another and from the mining seed, on every rank
_DROPOUT_SEED_STRIDE = 1_000_003


def train_generators(device, seed: int
                     ) -> Tuple[torch.Generator, Optional[torch.Generator]]:
    """(the dropout generator, the ITM mining generator) of a training step
    on `device`. In one process one generator seeded `seed` draws both, as
    the step always has. Over W > 1 ranks the mining one is seeded `seed`
    on every rank, so every rank mines the same pairs from the global
    similarity, and the dropout one is seeded by rank, so the ranks' rows
    do not share their masks (one global draw in the JAX package)."""
    if world_size() == 1:
        return torch.Generator(device=device).manual_seed(seed), None
    dropout = torch.Generator(device=device).manual_seed(
        seed + (rank() + 1) * _DROPOUT_SEED_STRIDE)
    return dropout, torch.Generator(device=device).manual_seed(seed)
