"""Epoch batching (counterpart of ``dgtd_tpu/data/loader.py``, one process,
no sharding).

The order and the augmentation are those of the JAX package for the same
seed (``default_rng`` streams keyed by seed, epoch and index), so a resumed
run can re-enter an epoch exactly. Batches are assembled on the host and
copied to ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch


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
    become tensors on it. ``epoch`` counts the epochs iterated so far."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, device: Optional[Union[str, torch.device]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = None if device is None else torch.device(device)
        self.epoch = 0

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

    def _make_batch(self, indices) -> Dict[str, Any]:
        train = getattr(self.dataset, "train_mode", False)
        samples = [
            self.dataset.get(int(i), np.random.default_rng((self.seed, self.epoch, int(i))) if train else None)
            for i in indices
        ]
        batch = collate(samples)
        if self.device is not None:
            batch = {
                k: torch.from_numpy(v).to(self.device) if isinstance(v, np.ndarray) and k != "raw" else v
                for k, v in batch.items()
            }
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._epoch_indices()
        # as in the JAX package, the counter moves on before the first batch
        # is made: epoch e shuffles with (seed, e) and flips with (seed, e + 1)
        self.epoch += 1
        for i in range(len(self)):
            yield self._make_batch(idx[i * self.batch_size : (i + 1) * self.batch_size])
