"""Input normalization (counterpart of ``dgtd_tpu/data/device_norm.py``).

uint8 inputs are normalized on the device; float inputs were normalized on
the host and pass through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) -> ImageNet-normalized float32; float input passes
    through (already normalized on the host)."""
    if x.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        return (x.float() / 255.0 - mean) / std
    return x


def scale_plane(x: torch.Tensor) -> torch.Tensor:
    """uint8 single-channel plane (depth/label) -> float32 in [0, 1]."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def normalize_batch(batch):
    """A batch dict with ``input`` normalized and uint8 ``depth``/``label``
    scaled to [0, 1]; other keys (the host-side ``raw``) pass through."""
    out = dict(batch)
    if "input" in out:
        out["input"] = normalize_image(out["input"])
    for k in ("depth", "label"):
        if k in out:
            out[k] = scale_plane(out[k])
    return out
