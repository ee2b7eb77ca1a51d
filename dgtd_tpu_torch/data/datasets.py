"""Datasets (counterpart of ``dgtd_tpu/data/datasets.py``).

Only the in-memory ``SyntheticSODDataset`` so far; the seven folder datasets
come with a later slice. Samples are numpy HWC float32 (uint8 with
``uint8_io``), as in the JAX package, and ``get(index, rng)`` takes the
per-index flip stream the loader hands it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.registry import DATASETS
from .device_norm import IMAGENET_MEAN, IMAGENET_STD


@DATASETS.register
class SyntheticSODDataset:
    """Geometric blobs with correlated depth, made from ``seed``: the same
    numpy draws as the JAX package's, so both give identical items."""

    train_mode = True

    def __init__(self, n: int = 8, size: int = 96, seed: int = 0, uint8_io: bool = False):
        self.size = size
        self.uint8_io = bool(uint8_io)
        rng = np.random.default_rng(seed)
        self._items = []
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        for _ in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            r = rng.uniform(0.12, 0.3)
            mask = (((xx - cx) ** 2 + (yy - cy) ** 2) < r**2).astype(np.float32)
            tex = rng.normal(0, 0.08, (size, size, 3)).astype(np.float32)
            image = np.clip(0.35 + 0.4 * mask[..., None] + tex, 0, 1)
            depth = np.clip(0.3 + 0.5 * mask + rng.normal(0, 0.03, (size, size)), 0, 1)
            self._items.append((image.astype(np.float32), mask[..., None], depth[..., None].astype(np.float32)))

    def __len__(self):
        return len(self._items)

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        """Item ``index``, flipped horizontally (all planes together) when
        ``rng`` draws < 0.5."""
        image, label, depth = self._items[index]
        if rng is not None and rng.random() < 0.5:
            image, label, depth = image[:, ::-1].copy(), label[:, ::-1].copy(), depth[:, ::-1].copy()
        if self.uint8_io:
            u8 = lambda a: np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
            return {"raw": image, "input": u8(image), "label": u8(label), "depth": u8(depth)}
        return {
            "raw": image,
            "input": (image - IMAGENET_MEAN) / IMAGENET_STD,
            "label": label,
            "depth": depth,
        }

    __getitem__ = get
