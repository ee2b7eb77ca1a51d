"""The registered ``cod`` and ``baseline`` models and their shared base
(counterpart of ``dgtd_tpu/models/cod.py``).

Modes: ``loss`` (train-mode forward and the total loss), ``predict`` and
``tensor`` (eval-mode forwards). Each runs in its mode whatever mode the
module is in, and puts the module back afterwards, as the JAX package's
``train=True/False`` does. The public functions keep the JAX package's
layout (NHWC in, NHWC out) so the two can be compared like with like.

Under a data×space layout (``parallel/space.py::active_space``), the
counterpart of the JAX package's ``model.predict`` on inputs sharded
``P('data', 'space')``, ``predict`` and ``tensor`` take the whole batch,
run this rank's rows of it on its band of H, and return those rows and
that band; ``space.gather_map`` joins the ranks' results into the whole
map. ``loss`` under a layout takes this rank's rows (what the loader gives
rank (d, s): data row d's rows of the global batch), runs the train
forward on its band of them, and returns its data row's loss, the same on
every space rank of the row (``parallel/space.py``'s convention). Every
registered model runs under a layout.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.registry import MODELS
from ..core.trace import span
from ..parallel import space
from ..parallel.dist import row_slice
from ..utils.image import resize_bilinear
from .hitnet import HitNet
from .layers import DropPath, init_parameters, set_drop_path_generator
from .losses import staged_losses, texture_ssim_loss


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return None if x is None else x.permute(0, 2, 3, 1)


class SegModel(nn.Module):
    """The modes shared by the registered models. A subclass builds its
    modules, calls :meth:`finish_init`, and defines ``forward(image, depth,
    H=None)`` on NCHW tensors -> (texture or None, [stage logits], second
    logits); ``H`` is the image's global height under a data×space layout.

    ``dtype`` is the compute policy: bfloat16 runs the forward under
    ``torch.autocast`` (LayerNorm statistics, softmax, BatchNorm statistics,
    the affinity normalization, the losses and the final sigmoid stay fp32);
    float32 runs it plainly. Parameters are always fp32. ``seed`` initializes
    them from a ``torch.Generator`` with the JAX package's schemes (None
    keeps PyTorch's default init, e.g. for a meta-device build).

    ``use_ssim`` adds the SSIM texture term to the loss when the forward
    returns a texture."""

    use_ssim = True

    def finish_init(self, dtype: torch.dtype, seed: Optional[int]) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))
        self.eval()

    @property
    def frozen_param_prefixes(self) -> Tuple[str, ...]:
        """Prefixes of the parameters the forward never uses; the optimizer
        leaves them as they are (``train/optim.py``), as the reference's DDP
        with ``find_unused_parameters=True`` does (their gradients stay
        None, so AdamW neither steps nor decays them)."""
        return ()

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

    def loss(self, image, depth, label, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode forward on NHWC image (B,H,W,3), depth and label
        (B,H,W,1) -> (total loss, {"loss_seg", ["loss_ssim",] "loss"}), fp32;
        ``loss_ssim`` only when the SSIM term is added. BatchNorm running
        statistics are updated. ``generator`` drives DropPath; it may be None
        only when every drop-path rate is 0. Under a data×space layout the
        inputs are this rank's rows, banded here; the loss is their data
        row's."""
        sp = space.current()
        if generator is None and any(isinstance(m, DropPath) and m.rate for m in self.modules()):
            raise ValueError(f"{type(self).__name__}.loss needs a generator for DropPath (or drop-path rates of 0)")
        h = image.shape[1]
        set_drop_path_generator(self, generator)
        try:
            with self._mode(True), self._autocast(image.device.type):
                if sp is None:
                    texture, stage_preds, pred2 = self(_nchw(image), _nchw(depth))
                else:
                    texture, stage_preds, pred2 = self(_nchw(space.band_rows(image, 1)),
                                                       _nchw(space.band_rows(depth, 1)), h)
        finally:
            set_drop_path_generator(self, None)
        with span("dgtd.loss"):
            loss = staged_losses(stage_preds, pred2, _nchw(label))
            aux = {"loss_seg": loss}
            if self.use_ssim and texture is not None:
                # the SSIM term on the whole rows: it carries no gradient
                texture = space.gather_rows(texture, self.texture_height(h))
                loss_ssim = texture_ssim_loss(texture, _nchw(image))
                loss = loss + loss_ssim
                aux["loss_ssim"] = loss_ssim
            aux["loss"] = loss
        return loss, aux

    def _forward(self, image, depth):
        """The eval forward of NHWC inputs -> NCHW outputs, and the image's
        global height; under a data×space layout on this rank's rows and
        band."""
        h = image.shape[1]
        with self._mode(False), self._autocast(image.device.type):
            if space.current() is None:
                return self(_nchw(image), _nchw(depth)), h
            sp = space.current()
            rows = row_slice(image.shape[0], sp.data_index, sp.data)
            image, depth = space.band_rows(image[rows], 1), space.band_rows(depth[rows], 1)
            return self(_nchw(image), _nchw(depth), h), h

    def texture_height(self, h: int) -> int:
        """The global height of the texture for an image of ``h`` rows."""
        return h

    @torch.inference_mode()
    def tensor(self, image, depth):
        """Raw eval-mode outputs in NHWC: (texture or None, [stage logits],
        second logits); under a data×space layout this rank's rows and band."""
        (texture, stage_preds, pred2), _ = self._forward(image, depth)
        return _nhwc(texture), [_nhwc(p) for p in stage_preds], _nhwc(pred2)

    @torch.inference_mode()
    def predict(self, image, depth, out_size=None):
        """Eval forward on NHWC image (B,H,W,3) and depth (B,H,W,1) ->
        ((B,H',W',1) fp32 probability map, {"texture": NHWC texture or None});
        under a data×space layout this rank's rows and band of each (the
        resize to ``out_size`` on the gathered logits)."""
        with span("dgtd.predict"):
            (texture, stage_preds, pred2), h = self._forward(image, depth)
            with self._autocast(image.device.type):
                logits = stage_preds[-1] + pred2
            if out_size is not None and tuple(out_size) != (h, image.shape[2]):
                logits = resize_bilinear(logits, out_size, in_h=h)
            prob = torch.sigmoid(logits.float())
        return _nhwc(prob), {"texture": _nhwc(texture)}


@MODELS.register
class cod(SegModel):
    """Paper model: HitNet on a texture-diffusion-prompted PVTv2, with the
    SSIM texture term in the loss.

    ``overrides`` are ``HitNet``'s hyperparameters (the ablation axes of
    ``docs/ABLATIONS.md`` among them) over ``net_kwargs``; an unknown one
    raises ``TypeError``. ``use_ssim`` turns the SSIM term on or off. The
    recipe's other model keys (``win_size``, ``filter_ratio``, ...) are
    accepted and unused, as in the reference."""

    use_ssim = True
    #: this model's HitNet settings; HitNet's defaults are ``cod``'s
    net_kwargs: Dict[str, Any] = {}

    def __init__(self, dtype: torch.dtype = torch.bfloat16, seed: Optional[int] = 0,
                 win_size=None, filter_ratio=None, using_depth=None, using_sam=None,
                 finetune=None, binary_thresh=None, pretrain_sam=None, head=None,
                 use_ssim: Optional[bool] = None, **overrides: Any):
        super().__init__()
        if use_ssim is not None:
            self.use_ssim = bool(use_ssim)
        self.hitnet = HitNet(**{**self.net_kwargs, **overrides})
        h = self.hitnet
        if self.use_ssim and h.fft_at_grid and h.use_prompts:
            # the grid-FFT texture is grid-sized; the SSIM term aligns the
            # texture with the full-resolution input
            raise ValueError(
                "use_ssim=True is incompatible with fft_at_grid=True: the grid-FFT texture is grid-sized and "
                "cannot align against the full-resolution input (set model.use_ssim=false, as the reference "
                "baseline does)"
            )
        self.finish_init(dtype, seed)

    def forward(self, image, depth, H=None):
        """NCHW forward -> (texture or None, [stage logits], second logits);
        ``H``: the image's global height under a data×space layout."""
        return self.hitnet(image, depth, H)

    def texture_height(self, h: int) -> int:
        """The grid's with ``fft_at_grid`` (the texture is grid-sized), else
        the image's."""
        return self.hitnet.backbone.prompt_encoder.grid if self.hitnet.fft_at_grid else h

    @property
    def frozen_param_prefixes(self) -> Tuple[str, ...]:
        """The prompt modules when they are built and not run
        (``inject_prompts=False``, ``baseline``)."""
        h = self.hitnet
        if h.use_prompts and not h.inject_prompts:
            return ("hitnet.backbone.prompt_encoder.", "hitnet.backbone.prompt_decoder.")
        return ()


@MODELS.register
class baseline(cod):
    """The reference's ``baseline``: ``cod`` without the SSIM term and
    without the prompts. It builds its diffusion modules (grid-FFT texture,
    freq 0.5, k = 3, 6 steps), so their keys are in its checkpoints, and runs
    none of them: the live network is a plain HitNet, and the prompt
    modules stay as they were initialized or loaded."""

    use_ssim = False
    net_kwargs = dict(freq_rate=0.5, diffusion_kernel=3, diffusion_steps=6, fft_at_grid=True,
                      inject_prompts=False)
