"""PVTv2 pyramid vision transformer (counterpart of ``dgtd_tpu/models/pvt.py``).

Tokens are (B, N, C) inside the blocks, as in the reference; the convolutions
(patch embed, spatial reduction, the MixFFN depthwise 3x3) see NCHW maps.
Per-block prompts (NCHW maps) are resized bilinearly to the stage grid and
added to the tokens before each block. Keys follow the official PVTv2
checkpoint under ``hitnet.backbone``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.image import resize_bilinear
from .layers import DropPath, LayerNorm, checkpointed, conv2d, linear

PVT_V2_CONFIGS = {
    # name: (embed_dims, num_heads, mlp_ratios, depths, sr_ratios)
    "tiny": ([8, 16, 32, 64], [1, 2, 4, 8], [2, 2, 2, 2], [1, 1, 1, 1], [8, 4, 2, 1]),
    "b0": ([32, 64, 160, 256], [1, 2, 5, 8], [8, 8, 4, 4], [2, 2, 2, 2], [8, 4, 2, 1]),
    "b1": ([64, 128, 320, 512], [1, 2, 5, 8], [8, 8, 4, 4], [2, 2, 2, 2], [8, 4, 2, 1]),
    "b2": ([64, 128, 320, 512], [1, 2, 5, 8], [8, 8, 4, 4], [3, 4, 6, 3], [8, 4, 2, 1]),
    "b3": ([64, 128, 320, 512], [1, 2, 5, 8], [8, 8, 4, 4], [3, 4, 18, 3], [8, 4, 2, 1]),
    "b4": ([64, 128, 320, 512], [1, 2, 5, 8], [8, 8, 4, 4], [3, 8, 27, 3], [8, 4, 2, 1]),
    "b5": ([64, 128, 320, 512], [1, 2, 5, 8], [4, 4, 4, 4], [3, 6, 40, 3], [8, 4, 2, 1]),
}


def _to_map(tokens, h, w):
    return tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], h, w)


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = conv2d(dim, dim, 3, 1, 1, groups=dim, init="pvt")

    def forward(self, x, h, w):
        return self.dwconv(_to_map(x, h, w)).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> depthwise 3x3 -> exact GELU -> fc2 (MixFFN)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = linear(hidden, dim)

    def forward(self, x, h, w):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Attention(nn.Module):
    """Spatial-reduction attention; the softmax is taken in fp32."""

    def __init__(self, dim, num_heads, sr_ratio=1):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.sr_ratio = sr_ratio
        self.q = linear(dim, dim)
        self.kv = linear(dim, 2 * dim)
        self.proj = linear(dim, dim)
        if sr_ratio > 1:
            self.sr = conv2d(dim, dim, sr_ratio, sr_ratio, init="pvt")
            self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x, h, w):
        b, n, c = x.shape
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh).permute(0, 2, 1, 3)
        if self.sr_ratio > 1:
            x = self.norm(self.sr(_to_map(x, h, w)).flatten(2).transpose(1, 2))
        kv = self.kv(x).reshape(b, -1, 2, nh, c // nh).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        attn = (q @ k.transpose(-2, -1)) * self.scale
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm attention and MixFFN, each residual branch through one
    DropPath (two independent draws per call)."""

    def __init__(self, dim, num_heads, mlp_ratio, sr_ratio, drop_path=0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, h, w):
        x = x + self.drop_path(self.attn(self.norm1(x), h, w))
        return x + self.drop_path(self.mlp(self.norm2(x), h, w))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv + LayerNorm (eps 1e-5)."""

    def __init__(self, cin, dim, patch, stride):
        super().__init__()
        self.proj = conv2d(cin, dim, patch, stride, patch // 2, init="pvt")
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        h, w = x.shape[-2:]
        return self.norm(x.flatten(2).transpose(1, 2)), h, w


class PVTv2(nn.Module):
    """4-stage PVTv2 pyramid. ``prompt_encoder``/``prompt_decoder``, when
    given, are registered here because the reference's backbone owns them
    (keys ``backbone.prompt_*``); the caller runs them and passes the
    per-block prompts to :meth:`forward`.

    ``drop_path_rate`` is the last block's stochastic-depth rate; the blocks
    get ``linspace(0, rate, Σdepths)`` in order (the dropout rates are all 0).
    ``remat`` recomputes each block's activations in backward instead of
    keeping them (``layers.checkpointed``), in a train-mode forward that
    records gradients.

    Returns the 4 stage maps (NCHW, strides 4/8/16/32)."""

    def __init__(self, variant="b2", prompt_encoder: Optional[nn.Module] = None,
                 prompt_decoder: Optional[nn.Module] = None, drop_path_rate: float = 0.1, remat: bool = False):
        super().__init__()
        self.remat = remat
        dims, heads, ratios, depths, srs = PVT_V2_CONFIGS[variant]
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur = 0
        for s in range(4):
            cin = 3 if s == 0 else dims[s - 1]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                cin, dims[s], patch=7 if s == 0 else 3, stride=4 if s == 0 else 2))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(dims[s], heads[s], ratios[s], srs[s], float(dpr[cur + i])) for i in range(depths[s])))
            cur += depths[s]
            setattr(self, f"norm{s + 1}", LayerNorm(dims[s], eps=1e-6))
        if prompt_encoder is not None:
            self.prompt_encoder = prompt_encoder
        if prompt_decoder is not None:
            self.prompt_decoder = prompt_decoder

    def forward(self, x, prompts: Optional[List[List[torch.Tensor]]] = None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for s in range(4):
            x, h, w = getattr(self, f"patch_embed{s + 1}")(x)
            for i, blk in enumerate(getattr(self, f"block{s + 1}")):
                if prompts is not None:
                    p = resize_bilinear(prompts[s][i], (h, w), exact=False)
                    x = x + p.flatten(2).transpose(1, 2).to(x.dtype)
                x = checkpointed(blk, x, h, w) if remat else blk(x, h, w)
            x = getattr(self, f"norm{s + 1}")(x)
            x = _to_map(x, h, w)
            outs.append(x)
        return outs
