"""Depth-guided texture diffusion, the paper's prompt modules (counterpart of
``dgtd_tpu/models/diffusion.py``).

``MessagePassing`` always runs in plane layout: the 1x1 affinity regressor's
NCHW output (B, C·k², h, w) is already ``view(B·C, k², h, w)``, channel
``o = c·k² + t``, so the stencil (``ops/diffusion.py``) needs no transposes.
On CUDA the stencil runs hand-written kernels at every grid size: at the
recipe's 12x12 grid all the steps in one launch of the fused forward and,
in backward, one of the fused backward; at grids 23 to 64 (the paper's grid
ablation) one launch each way of the cluster kernels. The gradient reaches
the affinity regressor through the fp32 normalization and its cast to x's
dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.diffusion import diffusion_planes
from ..utils.image import fft_high_pass, resize_bilinear, resize_nearest
from .convnext import EMBED_DIM, ConvNeXtFPNEncoder
from .layers import conv2d


def normalize_affinity(weight: torch.Tensor, dim: int, eps: float = 1e-5) -> torch.Tensor:
    """Random-walk normalization D^-1 A over the tap axis, in fp32."""
    weight = weight.float()
    return weight / (weight.sum(dim=dim, keepdim=True) + eps)


def affinity_planes(x: torch.Tensor, weight: torch.Tensor, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stencil's inputs from ``MessagePassing``'s: x (B, C, h, w) ->
    (B·C, h, w) planes; weight (B, C·k², h, w) -> normalized (B·C, k², h, w)
    in x's dtype."""
    b, c, h, w = x.shape
    wt = normalize_affinity(weight.reshape(b * c, kernel * kernel, h, w), dim=1)
    return x.reshape(b * c, h, w).contiguous(), wt.to(x.dtype).contiguous()


class MessagePassing(nn.Module):
    """Iterated affinity-weighted stencil, 1x1 conv to 3 channels, bilinear
    resize to the input resolution."""

    def __init__(self, latent_dim=24, kernel=7, steps=4):
        super().__init__()
        self.kernel = kernel
        self.steps = steps
        self.conv = conv2d(latent_dim, 3, 1, init="pvt")

    def forward(self, x, weight, out_size):
        b, c, h, w = x.shape
        xp, wt = affinity_planes(x, weight, self.kernel)
        xp = diffusion_planes(xp, wt, self.kernel, self.steps)
        return resize_bilinear(self.conv(xp.view(b, c, h, w)), out_size)


class ShapePropWeightRegressor(nn.Module):
    """1x1 conv texture -> per-pixel k*k affinities (sigmoid)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.reg = conv2d(cin, cout, 1, init="pvt")

    def forward(self, x):
        return torch.sigmoid(self.reg(x))


class PromptEncoder(nn.Module):
    """texture -> affinities -> depth diffusion -> ConvNeXt embedding, in the
    ``cod`` order: FFT at full resolution, nearest-downsample to the grid.

    Returns ``(texture, embedding)``: the full-resolution high-pass texture
    and the (B, EMBED_DIM, H/4, W/4) prompt embedding."""

    def __init__(self, latent_dim=24, grid=12, freq_rate=0.3, kernel=7, steps=4,
                 convnext_dims: Sequence[int] = (128, 256, 512, 1024),
                 convnext_depths: Sequence[int] = (3, 3, 27, 3), convnext_drop_path_rate: float = 0.4):
        super().__init__()
        self.grid = grid
        self.freq_rate = freq_rate
        self.propagation_weight_regressor = ShapePropWeightRegressor(3, latent_dim * kernel * kernel)
        self.encoder1 = conv2d(1, latent_dim, 1, init="pvt")
        self.message_passing = MessagePassing(latent_dim, kernel, steps)
        self.encoder2 = ConvNeXtFPNEncoder(convnext_dims, convnext_depths, convnext_drop_path_rate)

    def forward(self, image, depth):
        g = self.grid
        texture = fft_high_pass(image, self.freq_rate)
        tex_grid = resize_nearest(texture, (g, g))
        # a 1x1 conv and a bilinear resize commute, so the depth is resized
        # to the grid before encoder1 (as the JAX package does)
        depth_grid = resize_bilinear(depth, (g, g))
        weights = self.propagation_weight_regressor(tex_grid)
        cues = self.encoder1(depth_grid)
        diffused = self.message_passing(cues, weights, image.shape[-2:])
        return texture, self.encoder2(diffused + image)


class ShapePropDecoder(nn.Module):
    """3x3 conv x3 with ReLUs: embedding -> stage channels."""

    def __init__(self, out_dim, latent_dim=24):
        super().__init__()
        self.decoder = nn.Sequential(
            conv2d(EMBED_DIM, latent_dim, 3, 1, 1, init="pvt"), nn.ReLU(),
            conv2d(latent_dim, latent_dim, 3, 1, 1, init="pvt"), nn.ReLU(),
            conv2d(latent_dim, out_dim, 3, 1, 1, init="pvt"),
        )

    def forward(self, x):
        return self.decoder(x)


class PromptDecoder(nn.Module):
    """One ShapePropDecoder per transformer block of a stage."""

    def __init__(self, embed_dim, depth, latent_dim=24):
        super().__init__()
        self.decoder = nn.ModuleList(ShapePropDecoder(embed_dim, latent_dim) for _ in range(depth))

    def forward(self, embedding) -> List[torch.Tensor]:
        return [d(embedding) for d in self.decoder]
