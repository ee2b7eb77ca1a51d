"""The seeded inputs: a small pool of distinct uint8 NHWC batches on the
host, made from ``--seed`` in a few large calls, that a cell cycles
through.

Images are smooth random colour fields (noise at 1/16 of the size,
resized bilinearly) with pixel noise on top, depth maps smooth random
fields, masks a smooth random field thresholded at its mean: objects
with edges, so the losses' edge weights and the texture's high-pass see
structure. Every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def _smooth(gen: torch.Generator, n: int, c: int, size: int) -> torch.Tensor:
    low = torch.rand(n, c, max(size // 16, 1), max(size // 16, 1), generator=gen)
    return F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)


def make_pool(seed: int, batches: int, batch: int, size: int, labels: bool, pin: bool) -> List[Dict[str, torch.Tensor]]:
    """``batches`` dicts of uint8 NHWC ``input`` (B, S, S, 3), ``depth``
    (B, S, S, 1) and, with ``labels``, ``label`` (B, S, S, 1) in {0, 255};
    pinned when ``pin``."""
    words = np.random.SeedSequence([int(seed), 1]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed((int(words[0]) << 32) | int(words[1]))
    n = batches * batch
    image = 0.75 * _smooth(gen, n, 3, size) + 0.25 * torch.rand(n, 3, size, size, generator=gen)
    depth = _smooth(gen, n, 1, size)
    parts = {"input": image, "depth": depth}
    if labels:
        field = _smooth(gen, n, 1, size)
        parts["label"] = (field > field.mean(dim=(1, 2, 3), keepdim=True)).float()
    pool = []
    for k, v in parts.items():
        u8 = (v.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        parts[k] = u8
    for i in range(batches):
        b = {k: v[i * batch:(i + 1) * batch].clone() for k, v in parts.items()}
        pool.append({k: v.pin_memory() for k, v in b.items()} if pin else b)
    return pool


#: ImageNet normalization of the images (the recipe's)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def reference_batch(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """A host uint8 NHWC batch as the reference takes it: NCHW float32 on
    ``device``, the image ImageNet-normalized, depth and mask in [0, 1]."""
    out = {}
    for k, v in batch.items():
        x = v.to(device).permute(0, 3, 1, 2).float() / 255.0
        if k == "input":
            mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
            std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
            x = (x - mean) / std
        out[k] = x
    return out
