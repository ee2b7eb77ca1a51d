"""DPT depth head and the DINOv2 depther (counterpart of
``dgtd_tpu/models/dpt.py``).

``DinoDPTDepther`` is the reference's ``create_depther``: centre padding to
the patch size, the DINOv2 backbone's intermediate layers, the DPT head,
and a bilinear resize back to the unpadded input. Module names are the
mmseg ones of the released ``dinov2_vit*14_*_dpt_head.pth``:

  reassemble_blocks.readout_projects.{i}.0  Linear(2D -> D) + GELU on [tokens; cls]
  reassemble_blocks.projects.{i}.conv       1x1 conv D -> post_process_channels[i]
  reassemble_blocks.resize_layers.{i}       ConvTranspose2d x4, x2, identity, 3x3 stride 2
  convs.{i}.conv                            3x3 conv -> channels, no bias
  fusion_blocks.{i}                         residual conv units, x2 bilinear
                                            (align_corners=True), 1x1 project;
                                            block 0 has no res_conv_unit1
  project.conv                              3x3 conv + ReLU
  conv_depth                                3x3 conv -> n_bins (classify) or 1

The classify head (``classify=True``, the release's 256 UD bins with linear
normalization) takes the expectation over the bins in fp32.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.image import resize_bilinear
from .dinov2 import DINOV2_ARCHS, PATCH_SIZE, DinoViT

#: the released heads' depth range (NYU)
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0


def center_pad(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``CenterPadding``: zero-pad NCHW H and W up to a multiple, the smaller
    half (pad // 2) before."""
    h, w = x.shape[-2:]
    ph = math.ceil(h / multiple) * multiple - h
    pw = math.ceil(w / multiple) * multiple - w
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: keys ``<name>.conv.*``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=bias)

    def forward(self, x):
        return self.conv(x)


class ReassembleBlocks(nn.Module):
    """ViT token maps -> 4 maps at strides p/4, p/2, p and 2p."""

    def __init__(self, embed_dim: int, post_process_channels: Sequence[int] = (128, 256, 512, 1024)):
        super().__init__()
        ppc = list(post_process_channels)
        self.readout_projects = nn.ModuleList(
            [nn.Sequential(nn.Linear(2 * embed_dim, embed_dim), nn.GELU()) for _ in ppc])
        self.projects = nn.ModuleList([ConvModule(embed_dim, c, 1) for c in ppc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(ppc[0], ppc[0], 4, 4),
            nn.ConvTranspose2d(ppc[1], ppc[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(ppc[3], ppc[3], 3, 2, 1),
        ])

    def forward(self, inputs: List[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
        outs = []
        for i, (feat, cls) in enumerate(inputs):
            b, d, h, w = feat.shape
            tokens = feat.flatten(2).transpose(1, 2)
            x = self.readout_projects[i](torch.cat([tokens, cls[:, None].expand_as(tokens)], dim=-1))
            x = self.projects[i](x.transpose(1, 2).reshape(b, d, h, w))
            outs.append(self.resize_layers[i](x))
        return outs


class PreActResidualConvUnit(nn.Module):
    """x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvModule(channels, channels, 3, 1, 1)
        self.conv2 = ConvModule(channels, channels, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """(skip through res_conv_unit1, added) -> res_conv_unit2 -> x2 bilinear
    -> 1x1 project. A skip on another grid is resized to x's first
    (align_corners=False): odd grids (37 -> 19 -> 38 at 518²) need it."""

    def __init__(self, channels: int, first: bool = False):
        super().__init__()
        self.project = ConvModule(channels, channels, 1)
        self.res_conv_unit1 = None if first else PreActResidualConvUnit(channels)
        self.res_conv_unit2 = PreActResidualConvUnit(channels)

    def forward(self, x, skip=None):
        if skip is not None:
            skip = resize_bilinear(skip, tuple(x.shape[-2:]), align_corners=False, exact=False)
            x = x + self.res_conv_unit1(skip)
        x = self.res_conv_unit2(x)
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True, exact=False)
        return self.project(x)


class DPTHead(nn.Module):
    """The mmseg / DINOv2-release DPT depth head: (B, 1, H', W') fp32 depth."""

    def __init__(self, embed_dim: int, channels: int = 256,
                 post_process_channels: Sequence[int] = (128, 256, 512, 1024), classify: bool = True,
                 n_bins: int = 256, bins_strategy: str = "UD", norm_strategy: str = "linear"):
        super().__init__()
        if bins_strategy not in ("UD", "SID") or norm_strategy not in ("linear", "softmax", "sigmoid"):
            raise ValueError(f"unknown bins_strategy {bins_strategy!r} or norm_strategy {norm_strategy!r}")
        self.classify, self.n_bins = classify, n_bins
        self.bins_strategy, self.norm_strategy = bins_strategy, norm_strategy
        self.reassemble_blocks = ReassembleBlocks(embed_dim, post_process_channels)
        self.convs = nn.ModuleList(
            [ConvModule(c, channels, 3, 1, 1, bias=False) for c in post_process_channels])
        self.fusion_blocks = nn.ModuleList(
            [FeatureFusionBlock(channels, first=i == 0) for i in range(len(post_process_channels))])
        self.project = ConvModule(channels, channels, 3, 1, 1)
        self.conv_depth = nn.Conv2d(channels, n_bins if classify else 1, 3, 1, 1)

    def forward(self, inputs: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        feats = [conv(f) for conv, f in zip(self.convs, self.reassemble_blocks(inputs))]
        out = self.fusion_blocks[0](feats[-1])
        for i in range(1, len(feats)):
            out = self.fusion_blocks[i](out, feats[-(i + 1)])
        logits = self.conv_depth(F.relu(self.project(out)))
        with torch.autocast(logits.device.type, enabled=False):  # the expectation in fp32
            return self._depth(logits.float())

    def _depth(self, logits: torch.Tensor) -> torch.Tensor:
        if not self.classify:
            return F.relu(logits) + MIN_DEPTH
        if self.bins_strategy == "UD":
            bins = torch.linspace(MIN_DEPTH, MAX_DEPTH, self.n_bins, device=logits.device)
        else:
            bins = torch.logspace(math.log10(MIN_DEPTH), math.log10(MAX_DEPTH), self.n_bins, device=logits.device)
        if self.norm_strategy == "softmax":
            p = torch.softmax(logits, dim=1)
        else:
            p = F.relu(logits) + 0.1 if self.norm_strategy == "linear" else torch.sigmoid(logits)
            p = p / p.sum(dim=1, keepdim=True)
        return torch.einsum("bkhw,k->bhw", p, bins).unsqueeze(1)


def default_out_indices(depth: int) -> Tuple[int, ...]:
    """The release's blocks per backbone depth (vitl: 4, 11, 17, 23)."""
    known = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23), 40: (9, 19, 29, 39)}
    if depth in known:
        return known[depth]
    # np.linspace(depth // 6, depth - 1, 4).astype(int), as the JAX package
    start, step = depth // 6, (depth - 1 - depth // 6) / 3
    return tuple(int(i * step + start) for i in range(3)) + (depth - 1,)


class DinoDPTDepther(nn.Module):
    """CenterPadding -> DINOv2 intermediate layers -> DPT head -> bilinear
    resize (align_corners=False) to the input. ``forward`` takes NCHW
    normalized images, returns (B, 1, H, W) fp32 depth. ``dtype`` bfloat16
    runs it under autocast, as the JAX depther's "bfloat16" policy."""

    def __init__(self, arch: str = "vitl14", out_indices: Sequence[int] = (), classify: bool = True,
                 n_bins: int = 256, channels: int = 256,
                 post_process_channels: Sequence[int] = (128, 256, 512, 1024), pretrain_grid: int = 37,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        dim, depth, heads, ffn = DINOV2_ARCHS[arch]
        self.dtype = dtype
        self.out_indices = tuple(out_indices) or default_out_indices(depth)
        self.backbone = DinoViT(embed_dim=dim, depth=depth, num_heads=heads, ffn_layer=ffn,
                                pretrain_grid=pretrain_grid)
        self.decode_head = DPTHead(dim, channels, post_process_channels, classify, n_bins)

    def _autocast(self, x):
        return torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def features(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The backbone's part: centre padding and the intermediate layers."""
        with self._autocast(x):
            return self.backbone(center_pad(x, PATCH_SIZE), self.out_indices)

    def head(self, feats, size: Tuple[int, int]) -> torch.Tensor:
        """The head's part: the DPT head and the resize to ``size``."""
        with self._autocast(feats[0][0]):
            pred = self.decode_head(feats)
        return resize_bilinear(pred, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x), tuple(x.shape[-2:]))
