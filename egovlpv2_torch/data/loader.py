"""Host-side batching and the device feed (the port's copy of
`egovlpv2_tpu/data/loader.py`): `HostShardSampler`, `default_collate`, the
threaded `DataLoader`, `device_prefetch`, `RoundRobinLoader` and
`pretrain_post_fn`; the tokenizer is `data/tokenizer.py`.

Replaces the reference's torch DataLoader + DistributedSampler stack
(`base/base_data_loader.py`, `data_loader/data_loader.py`): a thread-pool
map over dataset indices with per-epoch host sharding.

`DevicePut` is the port's counterpart of the JAX package's
`parallel/mesh.py::shard_batch` on one card: it copies a numpy batch to
the device from pinned memory on a copy stream of its own, so that
`device_prefetch` can ship batch N+1 from its feeder thread while step N
computes; the consumer's stream waits for the copy when the batch is
handed over (`DeviceBatch.wait`).
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from egovlpv2_torch.data.mlm import mask_tokens
from egovlpv2_torch.data.tokenizer import Tokenizer


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


def _host_tensor(key, value) -> torch.Tensor:
    """An array of a batch (numpy, a list or a tensor) as a contiguous
    tensor, token ids and labels as int64, as torch's embedding and gather
    take them; everything else in its own type."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value)
                                 if np.ndim(value) else np.asarray(value))
    if isinstance(key, str) and key.startswith("text_") and key != "text_mask":
        value = value.long()
    return value.contiguous()


class DeviceBatch(dict):
    """A batch of tensors that `DevicePut` placed on `device`. `ready` is
    the event its copies end with on the copy stream (None once waited
    for, and on the CPU)."""

    device = None
    ready = None

    def wait(self) -> "DeviceBatch":
        """On the calling thread's current stream: wait for the copies and
        mark each tensor as read by that stream, so that the allocator of
        the copy stream, where they were allocated, does not hand their
        memory out again before that stream's work on them is done. The
        first call only; returns the batch."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.ready)
            for t in self.values():
                t.record_stream(stream)
            self.ready = None
        return self


class DevicePut:
    """put(batch) -> DeviceBatch on `device`: every array of the batch (a
    mapping of numpy arrays, lists or CPU tensors) as a tensor there, token
    ids and labels as int64.

    On a CUDA device, the calling thread names the device, then on this
    put's copy stream each array is pinned (`pin_memory`, from PyTorch's
    caching host allocator, which hands a block out again once its copy is
    done) and copied with `non_blocking=True`, and an event is recorded
    after the last copy. The call returns once the copies are queued; the
    consumer calls `DeviceBatch.wait` on the thread and stream that read the
    batch. On the CPU a put is `torch.as_tensor`, with no stream and no
    pinning."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def __call__(self, batch) -> DeviceBatch:
        out = DeviceBatch()
        out.device = self.device
        if self.copy_stream is None:
            for key, value in batch.items():
                out[key] = _host_tensor(key, value).to(self.device)
            return out
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            for key, value in batch.items():
                out[key] = _host_tensor(key, value).pin_memory().to(
                    self.device, non_blocking=True)
            out.ready = torch.cuda.Event()
            out.ready.record(self.copy_stream)
        return out


@functools.lru_cache(maxsize=None)
def device_put(device) -> DevicePut:
    """The one `DevicePut` (one copy stream) of `device` in this process."""
    return DevicePut(device)


def _hand_over(item):
    """An item of `device_prefetch` as the consumer receives it: a
    `DeviceBatch` waited for on the consumer's current stream."""
    return item.wait() if isinstance(item, DeviceBatch) else item


def device_prefetch(batches: Iterator, put_fn: Callable, depth: int = 2):
    """Overlap the host-to-device copy with device compute: a feeder thread
    runs `put_fn` (on a card, a `DevicePut`) up to `depth` batches ahead of
    the consumer, so that batch N+1's copy runs under step N's compute.
    A `DeviceBatch` is waited for (`DeviceBatch.wait`) on the consumer's
    thread and current stream when it is handed over: a wait issued on the
    feeder thread would order nothing for the consumer's stream.

    Batches come in order, each once. Up to `depth + 2` batches are live at
    once: `depth` in the queue, one put and waiting for room in it, one
    held by the consumer. `depth <= 0` puts inline, on the consumer's
    thread. An exception from `put_fn` or from the source re-raises at the
    consumer's next pull; abandoning the generator stops the feeder."""
    if depth <= 0:
        for b in batches:
            yield _hand_over(put_fn(b))
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def offer(item) -> None:
        # bounded put with a stop check, so that an abandoned generator
        # cannot wedge the feeder
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def feeder():
        try:
            for b in batches:
                offer((False, put_fn(b)))
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer's side
            offer((True, e))
            return
        offer(done)

    threading.Thread(target=feeder, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            is_err, val = item
            if is_err:
                raise val
            yield _hand_over(val)
    finally:
        stop.set()


class RoundRobinLoader:
    """Alternate batches across several loaders per step
    (base_data_loader.py:142 BaseMultiDataLoader)."""

    def __init__(self, loaders: Sequence[DataLoader]):
        self.loaders = list(loaders)

    def __len__(self):
        return sum(len(loader) for loader in self.loaders)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        iters = [loader.epoch(epoch) for loader in self.loaders]
        live = list(range(len(iters)))
        i = 0
        while live:
            idx = live[i % len(live)]
            try:
                yield next(iters[idx])
                i += 1
            except StopIteration:
                live.remove(idx)


def pretrain_post_fn(tokenizer: Tokenizer, mlm_prob: float = 0.15,
                     seed: int = 0) -> Callable:
    """Tokenize (scene negatives concatenated along the batch,
    trainer_egoclip.py:112-116) and apply MLM masking. The MLM ids and
    labels stay inside the model's vocabulary (`tokenizer.vocab_cap`)."""
    vocab = tokenizer.vocab_cap or Tokenizer.VOCAB
    mask_id = min(Tokenizer.MASK, vocab - 1)
    rng = np.random.default_rng(seed)

    def post(batch: Dict[str, Any]) -> Dict[str, Any]:
        texts = list(batch.pop("text"))
        out = dict(batch)
        if "text_neg" in batch:
            # the scene negatives double the batch
            texts = texts + list(out.pop("text_neg"))
            for key in ("video", "noun_vec", "verb_vec"):
                out[key] = np.concatenate([out[key], out.pop(key + "_neg")])
        tok = tokenizer(texts)
        out.update(tok)
        mlm_ids, mlm_labels = mask_tokens(tok["text_ids"], rng, mlm_prob,
                                          mask_id=mask_id, vocab_size=vocab)
        out["text_mlm_ids"] = mlm_ids.astype(np.int32)
        out["text_mlm_labels"] = mlm_labels.astype(np.int32)
        return out

    return post
