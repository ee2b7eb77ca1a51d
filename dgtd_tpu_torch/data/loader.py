"""Epoch batching (counterpart of ``dgtd_tpu/data/loader.py``).

The order and the augmentation are those of the JAX package for the same
seed (``default_rng`` streams keyed by seed, epoch and index), so a resumed
run can re-enter an epoch exactly. Batches are assembled on the host, on a
decode pool and a prefetch thread as the JAX package's are, and copied to
``device``. Under data parallelism each rank decodes only its rows of every
global batch, as each process of the JAX package's multi-host loader does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..parallel.dist import row_slice


def collate(samples) -> Dict[str, Any]:
    """Stack sample dicts into NHWC numpy batches; ``raw`` and strings stay
    per-sample lists (host-side only)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "raw" or isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack(vals, axis=0)
    return out


class DataLoader:
    """Epoch loader with seeded shuffling and per-index flip streams.
    ``device`` None keeps numpy batches; otherwise array fields (not ``raw``)
    become tensors on it. ``epoch`` counts the epochs iterated so far.

    ``num_workers`` > 0 runs ``dataset.get`` over a batch's indices on a
    thread pool (PIL's decode and the native pixel pipeline release the
    GIL); each index keeps its own flip stream, so the batches do not depend
    on the pool. ``prefetch`` > 0 makes the batches on a producer thread
    (``dgtd-prefetch``), at most ``prefetch`` ahead of the consumer: it
    decodes, collates and, for a CUDA device, pins the host arrays; the
    consumer's thread issues the copies to the device (non-blocking, on its
    current stream), so the producer launches no CUDA work. An exception in
    the producer is raised in the consumer; an iterator that is closed or
    dropped early releases the producer.

    ``rank`` and ``world`` split every global batch of ``batch_size`` over
    the ranks of a data-parallel run: every rank shuffles the same order and
    takes rows ``parallel/dist.py::row_slice`` of each batch (``raw`` holds
    this rank's rows); ``len`` counts global batches. A batch that the
    ranks do not divide raises, and so does a ragged last batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device: Optional[Union[str, torch.device]] = None,
                 num_workers: int = 0, prefetch: int = 2, rank: int = 0, world: int = 1):
        if world > 1 and not drop_last:
            raise ValueError("a loader split over ranks needs drop_last: a ragged last batch does not split evenly")
        self.rows = row_slice(batch_size, rank, world)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = None if device is None else torch.device(device)
        self.prefetch = int(prefetch)
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=int(num_workers)) if num_workers and num_workers > 0 else None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _host_batch(self, indices, epoch: int) -> Dict[str, Any]:
        """The batch of these indices on the host: numpy arrays, or pinned
        CPU tensors when the loader's device is CUDA."""
        train = getattr(self.dataset, "train_mode", False)

        def fetch(i):
            return self.dataset.get(int(i), np.random.default_rng((self.seed, epoch, int(i))) if train else None)

        samples = list(self._pool.map(fetch, indices)) if self._pool is not None else [fetch(i) for i in indices]
        batch = collate(samples)
        if self.device is not None:
            pin = self.device.type == "cuda"
            batch = {k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                     if isinstance(v, np.ndarray) and k != "raw" else v
                     for k, v in batch.items()}
        return batch

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if self.device is None:
            return batch
        return {k: v.to(self.device, non_blocking=True) if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._epoch_indices()
        chunks = [idx[i * self.batch_size : (i + 1) * self.batch_size][self.rows] for i in range(len(self))]
        # as in the JAX package, the counter moves on before the first batch
        # is made: epoch e shuffles with (seed, e) and flips with (seed, e + 1)
        self.epoch += 1
        epoch = self.epoch
        if self.prefetch <= 0:
            for c in chunks:
                yield self._to_device(self._host_batch(c, epoch))
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up once the consumer has left the epoch
            # (an exception in the step, the preemption return, a break): a
            # producer blocked in q.put would keep its thread and its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for c in chunks:
                    if stop.is_set() or not put(self._host_batch(c, epoch)):
                        return
                put(sentinel)
            except BaseException as e:  # noqa: BLE001
                # raised in the consumer: swallowing it would cut the epoch short
                put(e)

        t = threading.Thread(target=producer, daemon=True, name="dgtd-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._to_device(item)
        finally:
            # on exhaustion and on GeneratorExit (close(), or the iterator
            # dropped): release the producer and drop the queued batches
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
