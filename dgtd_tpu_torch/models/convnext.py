"""ConvNeXt tower + FPN fusion head, the texture-embedding encoder
(counterpart of ``dgtd_tpu/models/convnext.py``).

Keys follow the official ConvNeXt checkpoint plus the reference's FPN head
(``convs.<i>``, ``fusion_conv``) under ``hitnet.backbone.prompt_encoder.encoder2``.
Under a data×space layout (``parallel/space.py``) each level is this rank's
band, and ``h``/``H`` are the levels' global heights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.image import resize_bilinear
from .layers import DropPath, LayerNorm, LayerNorm2d, checkpointed, conv2d, linear, sequential

#: channels of the FPN-fused embedding (what the prompt decoders consume)
EMBED_DIM = 24


class Block(nn.Module):
    """dw7x7 -> LN -> Linear(4x) -> GELU -> Linear -> gamma -> DropPath, plus
    the residual."""

    def __init__(self, dim, drop_path=0.0):
        super().__init__()
        self.dwconv = conv2d(dim, dim, 7, 1, 3, groups=dim, init="pvt")
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = linear(dim, 4 * dim)
        self.pwconv2 = linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))  # layer scale, init 1.0
        self.drop_path = DropPath(drop_path)

    def forward(self, x, h=None):
        y = self.dwconv(x, h).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        y = self.drop_path(y * self.gamma.to(y.dtype))
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtFPNEncoder(nn.Module):
    """4-stage ConvNeXt on an RGB-sized input + stride-4 FPN fusion to
    ``EMBED_DIM`` channels. The blocks' stochastic-depth rates are
    ``linspace(0, drop_path_rate, Σdepths)`` in order. ``remat`` recomputes
    each block's activations in backward (``layers.checkpointed``), in a
    train-mode forward that records gradients."""

    def __init__(self, dims: Sequence[int] = (128, 256, 512, 1024), depths: Sequence[int] = (3, 3, 27, 3),
                 drop_path_rate: float = 0.4, remat: bool = False):
        super().__init__()
        self.remat = remat
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        starts = np.cumsum([0, *depths])
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(conv2d(3, dims[0], 4, 4, init="pvt"), LayerNorm2d(dims[0], eps=1e-6))]
            + [
                nn.Sequential(LayerNorm2d(dims[i - 1], eps=1e-6), conv2d(dims[i - 1], dims[i], 2, 2, init="pvt"))
                for i in range(1, len(dims))
            ]
        )
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(dims[i], float(dpr[starts[i] + j])) for j in range(depths[i])])
            for i in range(len(dims))
        )
        self.convs = nn.ModuleList(conv2d(d, EMBED_DIM, 1, init="pvt") for d in dims)
        self.fusion_conv = conv2d(EMBED_DIM * len(dims), EMBED_DIM, 1, init="pvt")

    def out_rows(self, H: int) -> int:
        """The embedding's global height for an input of ``H`` rows (the
        stem's output)."""
        return self.downsample_layers[0][0].out_rows(H)

    def forward(self, x, H=None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        h = x.shape[-2] if H is None else H
        outs, heights = [], []
        for down, stage in zip(self.downsample_layers, self.stages):
            x, h = sequential(down, x, h)
            for blk in stage:
                x = checkpointed(blk, x, h) if remat else blk(x, h)
            outs.append(x)
            heights.append(h)
        target = (heights[0], outs[0].shape[-1])
        lateral = [resize_bilinear(conv(o), target, exact=False, in_h=lh)
                   for conv, o, lh in zip(self.convs, outs, heights)]
        return self.fusion_conv(torch.cat(lateral, dim=1))
