"""Depth-guided texture diffusion, the paper's prompt modules (counterpart of
``dgtd_tpu/models/diffusion.py``).

``MessagePassing`` runs in plane layout unless
``core.flags.diffusion_plane_layout`` is ``False`` (read at each call): the
1x1 affinity regressor's NCHW output (B, C·k², h, w) is already
``view(B·C, k², h, w)``, channel ``o = c·k² + t``, so the stencil
(``ops/diffusion.py``) needs no transposes. Under ``False`` it runs the NHWC
stencil (``diffusion_nhwc``) on x and the weights moved to NHWC, as the JAX
package's NHWC branch does.
On CUDA the stencil runs hand-written kernels at every grid size: at the
recipe's 12x12 grid all the steps in one launch of the fused forward and,
in backward, one of the fused backward; at grids 23 to 64 (the paper's grid
ablation) one launch each way of the cluster kernels. The gradient reaches
the affinity regressor through the fp32 normalization and its cast to x's
dtype.

Under a data×space layout (``parallel/space.py``) every map is this rank's
band of rows: the texture's FFT and the resizes to the grid run on the
gathered level, the stencil on the banded grid through
``parallel/spatial.py`` (the halo'd band, one kernel launch a step), and
the 3x3 convs on their bands. Heights passed in are global.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..core import flags
from ..ops.diffusion import diffusion_nhwc, diffusion_planes
from ..parallel import space, spatial
from ..utils.image import fft_high_pass, resize_bilinear, resize_nearest
from .convnext import EMBED_DIM, ConvNeXtFPNEncoder
from .layers import conv2d, sequential


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


def affinity_nhwc(x: torch.Tensor, weight: torch.Tensor, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NHWC stencil's inputs from ``MessagePassing``'s: x (B, C, h, w) ->
    (B, h, w, C); weight (B, C·k², h, w) -> normalized (B, h, w, C, k²) in
    x's dtype, channel-major like the JAX package's NHWC weight."""
    b, c, h, w = x.shape
    kk = kernel * kernel
    nw = normalize_affinity(weight.reshape(b, c, kk, h, w).permute(0, 3, 4, 1, 2), dim=-1)
    return x.permute(0, 2, 3, 1).contiguous(), nw.to(x.dtype)


class MessagePassing(nn.Module):
    """Iterated affinity-weighted stencil, 1x1 conv to 3 channels, bilinear
    resize to the input resolution. Under a data×space layout ``h`` is the
    grid's global height: a banded grid runs the stencil on the halo'd band
    with the space group; a grid the layout replicates, or whose band is
    lower than the halo, runs it whole."""

    def __init__(self, latent_dim=24, kernel=7, steps=4):
        super().__init__()
        self.kernel = kernel
        self.steps = steps
        self.conv = conv2d(latent_dim, 3, 1, init="pvt")

    def forward(self, x, weight, out_size, h=None):
        if not space.split():
            out = self._diffuse(x, weight)
        else:
            space.refuse_grad(x, weight)
            if space.banded(h) and x.shape[-2] >= self.kernel // 2:
                space.count("banded")
                out = self._diffuse(x, weight, space.current().space_group)
            else:
                space.count("replicated")
                out = space.band_rows(self._diffuse(space.gather_rows(x, h), space.gather_rows(weight, h)))
        return resize_bilinear(self.conv(out), out_size, in_h=h)

    def _diffuse(self, x, weight, group=None):
        """The stencil's steps on (B, C, h, w) x, in the flag's layout; on
        this rank's rows with halos from ``group`` when one is given."""
        b, c, h, w = x.shape
        if flags.diffusion_plane_layout is False:
            xn, nw = affinity_nhwc(x, weight, self.kernel)
            if group is None:
                return diffusion_nhwc(xn, nw, self.kernel, self.steps).permute(0, 3, 1, 2)
            return spatial.spatial_nhwc(xn, nw, self.kernel, self.steps, group).permute(0, 3, 1, 2)
        xp, wt = affinity_planes(x, weight, self.kernel)
        if group is None:
            return diffusion_planes(xp, wt, self.kernel, self.steps).view(b, c, h, w)
        return spatial.spatial_planes(xp, wt, self.kernel, self.steps, group).view(b, c, h, w)


class ShapePropWeightRegressor(nn.Module):
    """1x1 conv texture -> per-pixel k*k affinities (sigmoid)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.reg = conv2d(cin, cout, 1, init="pvt")

    def forward(self, x):
        return torch.sigmoid(self.reg(x))


class PromptEncoder(nn.Module):
    """texture -> affinities -> depth diffusion -> ConvNeXt embedding.

    ``fft_at_grid`` picks the order of the texture: False (``cod``) takes the
    FFT high-pass at full resolution and nearest-downsamples it to the grid;
    True (``baseline``) resizes the image bilinearly to the grid and takes
    the FFT there, so the texture itself is grid-sized.

    Returns ``(texture, embedding)``: the high-pass texture and the
    (B, EMBED_DIM, H/4, W/4) prompt embedding. ``H``: the image's global
    height under a data×space layout."""

    def __init__(self, latent_dim=24, grid=12, freq_rate=0.3, kernel=7, steps=4, fft_at_grid=False,
                 convnext_dims: Sequence[int] = (128, 256, 512, 1024),
                 convnext_depths: Sequence[int] = (3, 3, 27, 3), convnext_drop_path_rate: float = 0.4,
                 remat: bool = False):
        super().__init__()
        self.grid = grid
        self.freq_rate = freq_rate
        self.fft_at_grid = fft_at_grid
        self.propagation_weight_regressor = ShapePropWeightRegressor(3, latent_dim * kernel * kernel)
        self.encoder1 = conv2d(1, latent_dim, 1, init="pvt")
        self.message_passing = MessagePassing(latent_dim, kernel, steps)
        self.encoder2 = ConvNeXtFPNEncoder(convnext_dims, convnext_depths, convnext_drop_path_rate, remat)

    def forward(self, image, depth, H=None):
        g = self.grid
        H = image.shape[-2] if H is None else H
        if self.fft_at_grid:
            texture = fft_high_pass(resize_bilinear(image, (g, g), in_h=H), self.freq_rate, in_h=g)
            tex_grid = texture
        else:
            texture = fft_high_pass(image, self.freq_rate, in_h=H)
            tex_grid = resize_nearest(texture, (g, g), in_h=H)
        # a 1x1 conv and a bilinear resize commute, so the depth is resized
        # to the grid before encoder1 (as the JAX package does)
        depth_grid = resize_bilinear(depth, (g, g), in_h=H)
        weights = self.propagation_weight_regressor(tex_grid)
        cues = self.encoder1(depth_grid)
        diffused = self.message_passing(cues, weights, (H, image.shape[-1]), g)
        return texture, self.encoder2(diffused + image, H)


class ShapePropDecoder(nn.Module):
    """3x3 conv x3 with ReLUs: embedding -> stage channels."""

    def __init__(self, out_dim, latent_dim=24):
        super().__init__()
        self.decoder = nn.Sequential(
            conv2d(EMBED_DIM, latent_dim, 3, 1, 1, init="pvt"), nn.ReLU(),
            conv2d(latent_dim, latent_dim, 3, 1, 1, init="pvt"), nn.ReLU(),
            conv2d(latent_dim, out_dim, 3, 1, 1, init="pvt"),
        )

    def forward(self, x, h=None):
        return sequential(self.decoder, x, h)[0]


class PromptDecoder(nn.Module):
    """One ShapePropDecoder per transformer block of a stage."""

    def __init__(self, embed_dim, depth, latent_dim=24):
        super().__init__()
        self.decoder = nn.ModuleList(ShapePropDecoder(embed_dim, latent_dim) for _ in range(depth))

    def forward(self, embedding, h=None) -> List[torch.Tensor]:
        return [d(embedding, h) for d in self.decoder]
