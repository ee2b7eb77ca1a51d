"""The registered ``cod`` model (counterpart of ``dgtd_tpu/models/cod.py``).

Modes: ``loss`` (train-mode forward and the total loss), ``predict`` and
``tensor`` (eval-mode forwards). Each runs in its mode whatever mode the
module is in, and puts the module back afterwards, as the JAX package's
``train=True/False`` does. ``baseline`` waits for a later slice. The public
functions keep the JAX package's layout (NHWC in, NHWC out) so the two can be
compared like with like.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.registry import MODELS
from ..utils.image import resize_bilinear
from .hitnet import HitNet
from .layers import DropPath, init_parameters, set_drop_path_generator
from .losses import staged_losses, texture_ssim_loss


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@MODELS.register
class cod(nn.Module):
    """Paper model: HitNet on a texture-diffusion-prompted PVTv2.

    ``dtype`` is the compute policy: bfloat16 runs the forward under
    ``torch.autocast`` (LayerNorm statistics, softmax, BatchNorm statistics,
    the affinity normalization, the losses and the final sigmoid stay fp32);
    float32 runs it plainly. Parameters are always fp32. ``seed`` initializes
    them from a ``torch.Generator`` with the JAX package's schemes (None
    keeps PyTorch's default init, e.g. for a meta-device build).
    ``overrides`` are ``HitNet``'s hyperparameters, whose defaults are the
    ``cod`` recipe's. The recipe's other model keys (``win_size``,
    ``filter_ratio``, ...) are accepted and unused, as in the reference."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, seed: Optional[int] = 0,
                 win_size=None, filter_ratio=None, using_depth=None, using_sam=None,
                 finetune=None, binary_thresh=None, pretrain_sam=None, head=None, **overrides: Any):
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

    @contextlib.contextmanager
    def _mode(self, train: bool):
        was = self.training
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

    def forward(self, image, depth):
        """NCHW forward -> (texture, [stage logits], second logits)."""
        return self.hitnet(image, depth)

    def loss(self, image, depth, label, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode forward on NHWC image (B,H,W,3), depth and label
        (B,H,W,1) -> (total loss, {"loss_seg", "loss_ssim", "loss"}), fp32.
        BatchNorm running statistics are updated. ``generator`` drives
        DropPath; it may be None only when every drop-path rate is 0."""
        if generator is None and any(isinstance(m, DropPath) and m.rate for m in self.modules()):
            raise ValueError("cod.loss needs a generator for DropPath (or drop-path rates of 0)")
        set_drop_path_generator(self, generator)
        try:
            with self._mode(True), self._autocast(image.device.type):
                texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
        finally:
            set_drop_path_generator(self, None)
        loss_seg = staged_losses(stage_preds, pred2, _nchw(label))
        loss_ssim = texture_ssim_loss(texture, _nchw(image))
        loss = loss_seg + loss_ssim
        return loss, {"loss_seg": loss_seg, "loss_ssim": loss_ssim, "loss": loss}

    @torch.inference_mode()
    def tensor(self, image, depth):
        """Raw eval-mode outputs in NHWC: (texture, [stage logits], second logits)."""
        with self._mode(False), self._autocast(image.device.type):
            texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
        return _nhwc(texture), [_nhwc(p) for p in stage_preds], _nhwc(pred2)

    @torch.inference_mode()
    def predict(self, image, depth, out_size=None):
        """Eval forward on NHWC image (B,H,W,3) and depth (B,H,W,1) ->
        ((B,H',W',1) fp32 probability map, {"texture": NHWC texture})."""
        with self._mode(False), self._autocast(image.device.type):
            texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
            logits = stage_preds[-1] + pred2
        if out_size is not None and tuple(out_size) != tuple(logits.shape[-2:]):
            logits = resize_bilinear(logits, out_size)
        prob = torch.sigmoid(logits.float())
        return _nhwc(prob), {"texture": _nhwc(texture)}
