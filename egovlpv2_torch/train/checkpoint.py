"""Checkpoint save and restore of a training run (port of
`egovlpv2_tpu/train/checkpoint.py`, over `torch.save` in place of orbax).

The interface and the sidecar files are the JAX manager's: `save(step,
state, metrics, is_best, epoch)` keeps the newest `max_to_keep`
checkpoints, `metrics_<step>.json`, `best_step.json` (the 'best' pointer),
`progress.json` (the last completed epoch) and `monitor.json` (a monitor's
best value and counter) sit beside them. A checkpoint is one file,
`step_<step>.pt`, written to a temporary name and renamed, so a reader
never sees half a file; saves are synchronous, so `wait` has nothing to
wait for. A directory that the JAX package saved is not read: orbax
imports jax.

`train_state` / `load_train_state_` give the state of a run as one
dictionary: the model's parameters, the optimizer's state (AdamW's
moments and step counts), the scheduler's, the dropout generator's, and
the step. Over W > 1 data-parallel ranks (`parallel/`) every rank calls
both: rank 0 holds the state, with every rank's dropout generator
(`rank_generators`) and the ITM mining generator that the ranks share
(`mining_generator`), and each rank takes its own back; a state resumes
only on as many ranks as saved it. Restoring it and stepping on gives the
run that never stopped, bit for bit. Only files this program wrote are
read (`weights_only`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

from egovlpv2_torch.parallel.collectives import all_gather_object
from egovlpv2_torch.parallel.distributed import (is_main_process, rank,
                                                 world_size)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def train_state(model: torch.nn.Module, optimizer, scheduler,
                generator: Optional[torch.Generator], step: int,
                mining_generator: Optional[torch.Generator] = None
                ) -> Optional[dict]:
    """The state of a training run, on the CPU. Over W > 1 ranks every rank
    calls it and rank 0 gets the state, with each rank's `generator` and
    the shared `mining_generator`; the other ranks get None."""
    gens = (all_gather_object(generator.get_state())
            if world_size() > 1 else None)
    if not is_main_process():
        return None
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "generator": None if generator is None else generator.get_state(),
        "step": int(step),
    }
    if gens is not None:
        state["rank_generators"] = gens
        state["mining_generator"] = (None if mining_generator is None
                                     else mining_generator.get_state())
    return state


def load_train_state_(state: dict, model: torch.nn.Module, optimizer,
                      scheduler, generator: Optional[torch.Generator],
                      mining_generator: Optional[torch.Generator] = None
                      ) -> int:
    """Puts `state` (from `train_state`) back into the run's objects, in
    place, this rank's generator from `rank_generators`; returns its step.
    A state saved by W ranks resumes on W."""
    saved = len(state.get("rank_generators") or [None])
    if saved != world_size():
        raise ValueError(f"the checkpoint was saved by {saved} processes; "
                         f"this run has {world_size()}")
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    if saved > 1:
        generator.set_state(state["rank_generators"][rank()])
        if state["mining_generator"] is not None:
            mining_generator.set_state(state["mining_generator"])
    elif generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
    return int(state["step"])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{int(step)}.pt")

    def _write_json(self, name: str, value: Any) -> None:
        with open(os.path.join(self._dir, name), "w") as f:
            json.dump(value, f)

    def _read_json(self, name: str) -> Optional[Any]:
        path = os.path.join(self._dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self._dir)) if m)

    def save(self, step: int, state: dict, metrics: Optional[dict] = None,
             is_best: bool = False, epoch: Optional[int] = None) -> None:
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self._max_to_keep]:
            os.remove(self._path(old))
        if metrics is not None:
            self._write_json(f"metrics_{step}.json",
                             {k: float(v) for k, v in metrics.items()})
        if is_best:
            self._write_json("best_step.json", {"step": int(step)})
        if epoch is not None:
            # epoch-granular progress: a resumed run continues at epoch+1
            # (the reference stores `epoch` in every .pth and restarts from
            # checkpoint_epoch + 1, base_trainer.py:412-436,438-495)
            self._write_json("progress.json",
                             {"epoch": int(epoch), "step": int(step)})

    def last_epoch(self) -> Optional[int]:
        """Last COMPLETED epoch recorded by save(..., epoch=), or None."""
        progress = self._read_json("progress.json")
        return None if progress is None else progress["epoch"]

    def restore(self, step: Optional[int] = None) -> Optional[Dict]:
        """The state saved at `step` (the latest by default), on the CPU;
        None when the directory holds no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore_params(self, step: Optional[int] = None,
                       prefer_best: bool = True) -> Optional[Dict]:
        """Only the model's parameters of a saved state, for entry points
        that have no optimizer state. With `prefer_best` and a best pointer,
        that step is restored. None when the directory holds no
        checkpoint."""
        if step is None and prefer_best:
            step = self.best_step()
        state = self.restore(step)
        return None if state is None else state["model"]

    def save_monitor(self, monitor_state: dict) -> None:
        """Persist monitored-metric progress (best value, early-stop counter)
        so a resumed run cannot regress the 'best' pointer (the reference
        keeps monitor_best in every .pth, base_trainer.py:412-436)."""
        self._write_json("monitor.json", monitor_state)

    def monitor_state(self) -> Optional[dict]:
        return self._read_json("monitor.json")

    def best_step(self) -> Optional[int]:
        best = self._read_json("best_step.json")
        return None if best is None else best["step"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""
