"""The single-process part of `egovlpv2_tpu/parallel/distributed.py`:
which process writes files, a rendezvous, and the SIGTERM flag that makes a
training loop save before it exits.

The multi-process start (`initialize_multihost`) waits for data parallel
over `torch.distributed`; `precompiled_epoch` is XLA's ahead-of-time
compilation before a collective and has no counterpart here.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    """Rank 0 of an initialised process group; else True (one process)."""
    return not _initialized() or dist.get_rank() == 0


def barrier(name: str) -> None:
    """Every process of an initialised process group meets here; a no-op in
    one process. `name` labels the rendezvous for the reader, as the JAX
    package's does."""
    del name
    if _initialized() and dist.get_world_size() > 1:
        dist.barrier()


class PreemptionGuard:
    """A SIGTERM flag: the handler only sets it (and runs `on_preempt`, at
    most once); a training loop polls `preempted` after each step and saves
    from its own context. Install it from the main thread (`signal.signal`
    refuses any other) and call `restore` on every way out of the loop, or
    the process keeps ignoring SIGTERM."""

    def __init__(self, on_preempt: Optional[Callable[[], None]] = None):
        self._fired = threading.Event()
        self._cb = on_preempt
        self._prev = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        if not self._fired.is_set():
            self._fired.set()
            if self._cb is not None:
                self._cb()

    @property
    def preempted(self) -> bool:
        return self._fired.is_set()

    def restore(self) -> None:
        """Reinstate the previous SIGTERM handler."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
