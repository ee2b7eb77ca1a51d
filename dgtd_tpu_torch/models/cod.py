"""The registered ``cod`` model (counterpart of ``dgtd_tpu/models/cod.py``).

Serving modes only: ``predict`` and ``tensor``. ``loss`` and ``baseline``
arrive with the training slice. The public functions keep the JAX package's
layout (NHWC in, NHWC out) so the two can be compared like with like.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ..core.registry import MODELS
from ..utils.image import resize_bilinear
from .hitnet import HitNet
from .layers import init_parameters


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@MODELS.register
class cod(nn.Module):
    """Paper model: HitNet on a texture-diffusion-prompted PVTv2.

    ``dtype`` is the compute policy: bfloat16 runs the forward under
    ``torch.autocast`` (LayerNorm statistics, softmax, the affinity
    normalization and the final sigmoid stay fp32); float32 runs it plainly.
    Parameters are always fp32. ``seed`` initializes them from a
    ``torch.Generator`` with the JAX package's schemes (None keeps PyTorch's
    default init, e.g. for a meta-device build). ``overrides`` are
    ``HitNet``'s hyperparameters, whose defaults are the ``cod`` recipe's."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, seed: Optional[int] = 0, **overrides: Any):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        self.hitnet = HitNet(**overrides)
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))
        self.eval()

    def _autocast(self, device_type: str):
        return torch.autocast(device_type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def forward(self, image, depth):
        """NCHW forward -> (texture, [stage logits], second logits)."""
        return self.hitnet(image, depth)

    @torch.inference_mode()
    def tensor(self, image, depth):
        """Raw forward outputs in NHWC: (texture, [stage logits], second logits)."""
        with self._autocast(image.device.type):
            texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
        return _nhwc(texture), [_nhwc(p) for p in stage_preds], _nhwc(pred2)

    @torch.inference_mode()
    def predict(self, image, depth, out_size=None):
        """Eval forward on NHWC image (B,H,W,3) and depth (B,H,W,1) ->
        ((B,H',W',1) fp32 probability map, {"texture": NHWC texture})."""
        with self._autocast(image.device.type):
            texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
            logits = stage_preds[-1] + pred2
        if out_size is not None and tuple(out_size) != tuple(logits.shape[-2:]):
            logits = resize_bilinear(logits, out_size)
        prob = torch.sigmoid(logits.float())
        return _nhwc(prob), {"texture": _nhwc(texture)}
