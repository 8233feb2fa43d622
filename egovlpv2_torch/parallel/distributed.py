"""The process group of a run over several processes, one device each
(counterpart of `egovlpv2_tpu/parallel/distributed.py`): its start
(`initialize_multihost`), which process writes files, a rendezvous, and the
SIGTERM flag that makes a training loop save before it exits.

A rank drives one device: `cuda:<LOCAL_RANK>` over NCCL, or the CPU over
gloo. The JAX package's `jax.distributed` becomes `torch.distributed`; its
Cloud TPU auto-discovery becomes the launcher's environment (`RANK`,
`WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`, as torchrun sets
them). `precompiled_epoch` is XLA's ahead-of-time compilation before a
collective and has no counterpart here.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The processes of the initialised group; 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    """This process's rank in the initialised group; 0 without one."""
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    """Rank 0 of an initialised process group; else True (one process)."""
    return rank() == 0


def barrier(name: str) -> None:
    """Every process of an initialised process group meets here; a no-op in
    one process. `name` labels the rendezvous for the reader, as the JAX
    package's does."""
    del name
    if world_size() > 1:
        dist.barrier()


def _rank_device(device: torch.device) -> torch.device:
    """The device this rank drives: on CUDA `cuda:<LOCAL_RANK>` where the
    launcher set it, else the index `device` names, else `cuda:0`."""
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not "
                           "available")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else (device.index or 0)
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK / device index {index}, but this "
                           f"host has {torch.cuda.device_count()} CUDA "
                           "devices")
    return torch.device("cuda", index)


def _device_identity(device: torch.device) -> Optional[str]:
    """What tells two CUDA devices apart across hosts (its UUID, else the
    host and index); None for the CPU, which any number of ranks share."""
    if device.type != "cuda":
        return None
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return (f"GPU-{uuid}" if uuid is not None
            else f"{socket.gethostname()}:cuda:{device.index}")


def shared_devices(identities: List[Optional[str]]) -> Dict[str, List[int]]:
    """identity -> the ranks that took it, for every device more than one
    rank took (None, the CPU, is never shared)."""
    taken: Dict[str, List[int]] = {}
    for r, ident in enumerate(identities):
        if ident is not None:
            taken.setdefault(ident, []).append(r)
    return {ident: ranks for ident, ranks in taken.items() if len(ranks) > 1}


def refuse_shared_devices(store, rank_: int, world: int,
                          identity: Optional[str]) -> None:
    """Every rank posts the device it took to the rendezvous store and reads
    the others'; two ranks on one device raise on every rank, before any
    collective (NCCL refuses a duplicate GPU, and a collective there could
    hang instead of failing). Rank 0 serves a TCP store, so it leaves only
    once every rank has read."""
    store.set(f"egovlpv2/device/{rank_}", identity or "")
    keys = [f"egovlpv2/device/{r}" for r in range(world)]
    store.wait(keys)
    identities = [store.get(k).decode() or None for k in keys]
    store.set(f"egovlpv2/device_read/{rank_}", "1")
    if rank_ == 0:
        store.wait([f"egovlpv2/device_read/{r}" for r in range(world)])
    shared = shared_devices(identities)
    if shared:
        clash = "; ".join(f"ranks {ranks} on {ident}"
                          for ident, ranks in shared.items())
        raise RuntimeError(
            f"two ranks on one device: {clash}. Give each process its own "
            "card: set LOCAL_RANK (torchrun does) or --device cuda:<i>")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda",
                         timeout: timedelta = timedelta(minutes=30)) -> dict:
    """Starts the process group of this rank and returns its topology: the
    JAX function's keys (`process_index`, `process_count`, `local_devices`,
    `global_devices`), `device`, the one this rank drives, and `backend`.

    `coordinator_address` is host:port of process 0 (a TCP rendezvous), or
    a `tcp://` or `file://` URL, and comes with `num_processes` and
    `process_id`; without it the launcher's environment names the group
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A CUDA `device` takes
    NCCL and the CPU gloo, as the caller asks: NCCL that does not start
    raises. Two ranks on one card are refused before any collective."""
    device = _rank_device(torch.device(device))
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        store, rank_, world = next(dist.rendezvous(
            url, rank=process_id, world_size=num_processes, timeout=timeout))
    else:
        missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"--multihost without --coordinator reads the launcher's "
                f"environment (torchrun), which lacks {missing}")
        store, rank_, world = next(dist.rendezvous("env://", timeout=timeout))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    refuse_shared_devices(store, rank_, world, _device_identity(device))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank_, world_size=world,
                            timeout=timeout)
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": 1, "global_devices": world_size(),
            "device": device, "backend": dist.get_backend()}


def shutdown() -> None:
    """Ends this process's group, where one is up."""
    if _initialized():
        dist.destroy_process_group()


class PreemptionGuard:
    """A SIGTERM flag: the handler only sets it (and runs `on_preempt`, at
    most once); a training loop polls `preempted` after each step and saves
    from its own context. Under a process group the ranks agree on it
    (`parallel.collectives.any_rank`), so that a signal to one rank stops
    them all at one step. Install it from the main thread (`signal.signal`
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
