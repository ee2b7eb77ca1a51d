"""Datasets (counterpart of ``dgtd_tpu/data/datasets.py``).

The reference's seven folder loaders, one class each with the same registry
name, directory layout, sorted listings, the COD10K test partition
(``sorted[3381:]``), the image/GT size screen and the per-item dict
``{"raw", "input", "label", "depth"}``; and the in-memory
``SyntheticSODDataset``. Samples are numpy HWC float32 (uint8 with
``uint8_io``), as in the JAX package, and ``get(index, rng)`` takes the
per-index flip stream the loader hands it (a train split flips when it
draws < 0.5).

Decoding is PIL's. The resize is PIL's bilinear (``pipeline: pil``, the
default) or the fused C++ half-pixel bilinear resize, normalize and flip of
``native/pixelops.cpp`` (``pipeline: native``), which gives the JAX
package's native pixels bit for bit. Where the JAX package falls back to PIL
when its library cannot build, the port raises: PIL's resample gives other
pixels.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
from PIL import Image

from ..core.registry import DATASETS
from ..native import pixelops
from .device_norm import IMAGENET_MEAN, IMAGENET_STD


def _list_dir(root: str, sub: str) -> List[str]:
    d = os.path.join(root, sub)
    return [os.path.join(d, f) for f in os.listdir(d)]


class FolderSODDataset:
    """One loader behind the seven registered folder datasets: images in
    ``data_dir/<nested>/<image_subdir>``, masks in ``GT``, depth maps in
    ``depth_dir``, paired by sorted order."""

    image_subdir = "Imgs"
    gt_subdir = "GT"
    size = 384
    train_mode = False
    #: path components between data_dir and the subdirs (NC4K: ("train",))
    nested = ()
    #: files skipped at the head of each sorted listing (the COD10K test partition)
    skip_first = 0
    #: ``raw`` is the image's path (else the resized, unnormalized image)
    raw_as_path = False

    def __init__(self, data_dir: str, depth_dir: str, split: str,
                 image_size: Optional[Union[int, tuple, list]] = None, filter_size_mismatch: bool = True,
                 pipeline: str = "pil", uint8_io: bool = False):
        if pipeline not in ("pil", "native"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if pipeline == "native":
            pixelops.load()  # builds the library now, or raises
        self.pipeline = pipeline
        #: ship the resized uint8 planes and normalize on the device
        self.uint8_io = bool(uint8_io)
        self._check_split(split)
        base = os.path.join(data_dir, *self.nested)
        self.images = sorted(_list_dir(base, self.image_subdir))[self.skip_first :]
        self.gts = sorted(_list_dir(base, self.gt_subdir))[self.skip_first :]
        self.depths = sorted(_list_dir(base, depth_dir))[self.skip_first :]
        if filter_size_mismatch:
            self._filter_files()
        if image_size is not None:
            self.size = int(image_size[0]) if isinstance(image_size, (tuple, list)) else int(image_size)

    def _check_split(self, split: str) -> None:
        if split not in ("train", "test", "val"):
            raise NotImplementedError(f"Unsupported split {split}")
        if self.train_mode and split != "train":
            raise ValueError(f"{type(self).__name__} is a training split")
        if not self.train_mode and split == "train":
            raise ValueError(f"{type(self).__name__} is an eval split")

    def _filter_files(self) -> None:
        """Drop the items whose image and GT sizes differ. Depth maps pair
        by sorted index, so a depth directory that does not pair 1:1 raises
        (it would pair an image with another's depth once anything is
        dropped)."""
        if len(self.images) != len(self.gts):
            raise ValueError(f"{type(self).__name__}: {len(self.images)} images but {len(self.gts)} GT masks")
        if len(self.depths) != len(self.images):
            raise ValueError(
                f"{type(self).__name__}: depth dir has {len(self.depths)} files for {len(self.images)} images; "
                "depth maps must pair 1:1 with the images"
            )
        keep = []
        for item in zip(self.images, self.gts, self.depths):
            with Image.open(item[0]) as img, Image.open(item[1]) as gt:
                if img.size == gt.size:
                    keep.append(item)
        self.images, self.gts, self.depths = (list(col) for col in zip(*keep)) if keep else ([], [], [])

    def __len__(self) -> int:
        return len(self.images)

    def _load_u8(self, path: str, mode: str) -> np.ndarray:
        """The file decoded in ``mode`` and PIL-bilinear resized to size²,
        HWC uint8."""
        with Image.open(path) as im:
            arr = np.asarray(im.convert(mode).resize((self.size, self.size), Image.BILINEAR), np.uint8)
        return arr[:, :, None] if arr.ndim == 2 else arr

    def _decode(self, path: str, mode: str) -> np.ndarray:
        """The file decoded in ``mode``, HWC uint8 at its own size."""
        with Image.open(path) as im:
            arr = np.asarray(im.convert(mode), np.uint8)
        return arr[:, :, None] if arr.ndim == 2 else arr

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """Item ``index``; a train split flips every plane (and ``raw``)
        together when ``rng`` draws < 0.5."""
        flip = bool(self.train_mode and rng is not None and rng.random() < 0.5)
        files = ((self.images[index], "RGB"), (self.gts[index], "L"), (self.depths[index], "L"))
        if self.pipeline == "native":
            return self._get_native(index, [self._decode(path, mode) for path, mode in files], flip)
        planes = [self._load_u8(path, mode) for path, mode in files]
        if flip:
            planes = [p[:, ::-1].copy() for p in planes]
        image, label, depth = planes if self.uint8_io else [p.astype(np.float32) / 255.0 for p in planes]
        # raw flips in lockstep with input: the reference's raw transform
        # draws the same flip (cod10k_camo_train.py:47-50,75)
        raw = self.images[index] if self.raw_as_path else image
        if self.uint8_io:  # normalized on the device
            return {"raw": raw, "input": image, "label": label, "depth": depth}
        return {"raw": raw, "input": (image - IMAGENET_MEAN) / IMAGENET_STD, "label": label, "depth": depth}

    def _get_native(self, index: int, decoded, flip: bool) -> Dict[str, np.ndarray]:
        """The item through the fused pipeline, as the JAX package's native
        route makes it: the image normalized in the same pass (or, with
        ``uint8_io``, every plane resized to uint8), ``raw`` the resized
        unnormalized image flipped with the input."""
        size = (self.size, self.size)
        img, gt, dep = decoded
        if self.uint8_io:
            image, label, depth = (pixelops.resize_u8(p, size, flip) for p in decoded)
            raw = image
        else:
            image = pixelops.resize_normalize(img, size, IMAGENET_MEAN, IMAGENET_STD, flip)
            label, depth = (pixelops.resize_normalize(p, size, flip=flip) for p in (gt, dep))
            raw = None if self.raw_as_path else pixelops.resize_normalize(img, size, flip=flip)
        return {"raw": self.images[index] if self.raw_as_path else raw, "input": image, "label": label,
                "depth": depth}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get(index, None)


@DATASETS.register
class COD10K_CAMO_TRAIN(FolderSODDataset):
    """COD train (COD10K + CAMO), 384², paired flips (cod10k_camo_train.py:12)."""

    image_subdir = "Imgs"
    train_mode = True


@DATASETS.register
class COD10K_TEST(FolderSODDataset):
    """COD10K test partition: sorted[3381:], 384², raw = path (cod10k_test.py:24-26,53)."""

    image_subdir = "Image"
    skip_first = 3381
    raw_as_path = True


@DATASETS.register
class COD_TEST(FolderSODDataset):
    """CAMO test, 704² (camo_test.py:10); raw = the resized image."""

    image_subdir = "Image"
    size = 704


@DATASETS.register
class CHAMELEON(FolderSODDataset):
    """CHAMELEON test, 704²; raw = the resized image."""

    image_subdir = "Image"
    size = 704


@DATASETS.register
class NC4K(FolderSODDataset):
    """NC4K test, 704², nested under train/; raw = the resized image."""

    image_subdir = "Image"
    size = 704
    nested = ("train",)


@DATASETS.register
class SOD_TRAIN(FolderSODDataset):
    """RGB-D SOD train, RGB/ image dir, 384², paired flips (sod_train.py:12)."""

    image_subdir = "RGB"
    train_mode = True


@DATASETS.register
class SOD_TEST(FolderSODDataset):
    """RGB-D SOD test (NJU2K in configs/sod.yml), 384², raw = path (sod_test.py:52)."""

    image_subdir = "RGB"
    raw_as_path = True


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
