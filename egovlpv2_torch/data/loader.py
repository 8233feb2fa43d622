"""Host-side batching (the port's copy of part of
`egovlpv2_tpu/data/loader.py`): `HostShardSampler`, `default_collate` and
the threaded `DataLoader`, which the EgoTaskQA fine-tune batches with.
`device_prefetch`, `RoundRobinLoader` and `pretrain_post_fn` are not
copied yet (ROADMAP.md A7); the tokenizer is `data/tokenizer.py`.

Replaces the reference's torch DataLoader + DistributedSampler stack
(`base/base_data_loader.py`, `data_loader/data_loader.py`): a thread-pool
map over dataset indices with per-epoch host sharding.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


class HostShardSampler:
    """Deterministic per-epoch shuffling + host sharding.

    Equivalent of torch DistributedSampler(set_epoch) (`base_data_loader.py:130`,
    `trainer_egoclip.py:104`): every host sees a disjoint 1/num_hosts slice of
    a seed+epoch-keyed permutation, padded to equal length.
    """

    def __init__(self, length: int, num_hosts: int = 1, host_id: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.length = length
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.shuffle = shuffle
        self.seed = seed

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.length)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        per_host = -(-self.length // self.num_hosts)
        pad = per_host * self.num_hosts - self.length
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.host_id::self.num_hosts]


def default_collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # e.g. raw caption strings
    return out


class DataLoader:
    """Threaded prefetch loader: dataset[i] -> collate -> (optional) post_fn.

    `num_workers` threads decode items concurrently (cv2/ffmpeg release the
    GIL); a coordinator thread keeps `prefetch` whole batches in flight and
    preserves batch order, so consumers see the same stream a sequential
    loader would produce. Threads, not processes: the hot path is C code
    that releases the GIL — the decoder, and (when built) the C++ videoproc
    library that transforms.py routes resize/normalize through.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[HostShardSampler] = None,
        num_workers: int = 4,
        collate: Callable = default_collate,
        post_fn: Optional[Callable] = None,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or HostShardSampler(len(dataset), shuffle=False)
        self.num_workers = max(num_workers, 1)
        self.collate = collate
        self.post_fn = post_fn
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.sampler.indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        idx = self.sampler.indices(epoch)
        n_batches = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
                    # keep `prefetch + 1` whole batches of item-futures in
                    # flight; batches complete in submission order so the
                    # output stream is deterministic.
                    pending: collections.deque = collections.deque()
                    batch_iter = iter(batches)

                    def submit_one() -> bool:
                        batch_idx = next(batch_iter, None)
                        if batch_idx is None:
                            return False
                        pending.append(
                            [ex.submit(self.dataset.__getitem__, int(i))
                             for i in batch_idx]
                        )
                        return True

                    for _ in range(self.prefetch + 1):
                        if not submit_one():
                            break
                    while pending and not stop.is_set():
                        futs = pending.popleft()
                        items = [f.result() for f in futs]
                        submit_one()
                        batch = self.collate(items)
                        if self.post_fn is not None:
                            batch = self.post_fn(batch)
                        # bounded put with a stop check so an abandoned
                        # generator can't wedge the producer forever
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.2)
                                break
                            except queue.Full:
                                continue
                    for futs in pending:
                        for f in futs:
                            f.cancel()
            finally:
                while True:
                    try:
                        q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
