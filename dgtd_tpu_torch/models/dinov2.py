"""DINOv2 vision transformer, the offline depther's encoder (counterpart of
``dgtd_tpu/models/dinov2.py``).

Module and parameter names are the official ``facebookresearch/dinov2``
ones (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1/attn.qkv/attn.proj/ls1.gamma/norm2/mlp.fc1/mlp.fc2``,
``mlp.w12/mlp.w3`` for the fused SwiGLU FFN, ``norm``), so that a released
``dinov2_vit*14_pretrain.pth`` loads with ``load_state_dict`` once its
inference-unused ``mask_token`` (and ``register_tokens``) are dropped
(``convert.load_depther_part``).

The forward is ``get_intermediate_layers(n=out_indices, reshape=True,
return_class_token=True, norm=final_norm)``, the one entry point the depther
uses. The positional embedding is resized with upstream's own call,
bicubic ``F.interpolate`` with ``scale_factor=(h0 + 0.1) / M`` per axis (the
``interpolate_offset`` quirk), in fp32.

Compute policy as in the JAX package: under bf16 autocast the tokens and
the residual stream stay bf16, the LayerNorm statistics and the attention
softmax run in fp32. Each attention call (the SDPA alone) opens the span
``dgtd.depther.attention`` (``core/trace.py``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.trace import span
from .layers import LayerNorm

# (embed_dim, depth, num_heads, ffn_layer) for the four released sizes; the
# giant uses the fused-SwiGLU FFN (hub dinov2_vitg14: ffn_layer="swiglufused")
DINOV2_ARCHS = {
    "vits14": (384, 12, 6, "mlp"),
    "vitb14": (768, 12, 12, "mlp"),
    "vitl14": (1024, 24, 16, "mlp"),
    "vitg14": (1536, 40, 24, "swiglufused"),
}

#: checkpoint keys that inference never reads
UNUSED_KEYS = ("mask_token", "register_tokens")
PATCH_SIZE, MLP_RATIO = 14, 4.0


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int], offset: float = 0.1) -> torch.Tensor:
    """DINOv2 ``interpolate_pos_encoding``: (1, 1 + M·M, D) -> (1, 1 + h0·w0, D)
    in fp32, the patch grid row-major like the patch tokens.

    Upstream unpacks ``B, nc, w, h = x.shape``, so its ``w`` is the height:
    its first scale factor, applied to the height axis, is the height's
    ``(h0 + offset) / M``. That is the natural (h0, w0) orientation here."""
    n = pos_embed.shape[1] - 1
    m = int(math.sqrt(n))
    if m * m != n:
        raise ValueError(f"pos_embed holds {n} patch positions, not a square grid")
    h0, w0 = grid_hw
    if (h0, w0) == (m, m):
        return pos_embed
    grid = pos_embed[:, 1:].float().reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((h0 + offset) / m, (w0 + offset) / m), mode="bicubic",
                         antialias=False)
    if tuple(grid.shape[-2:]) != (h0, w0):
        raise ValueError(f"pos_embed resized to {tuple(grid.shape[-2:])}, expected {(h0, w0)}")
    grid = grid.permute(0, 2, 3, 1).reshape(1, h0 * w0, -1)
    return torch.cat([pos_embed[:, :1].float(), grid], dim=1)


class PatchEmbed(nn.Module):
    """Conv 14/s14: one token a patch."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH_SIZE, PATCH_SIZE)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoAttention(nn.Module):
    """Fused-qkv multi-head self-attention (dinov2 ``MemEffAttention``); the
    softmax in fp32, its output in the compute dtype."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, c = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        with span("dgtd.depther.attention"):
            out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, t, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2 (ViT-S/B/L)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFN(nn.Module):
    """w12, silu(x1)·x2, w3 (dinov2 ``SwiGLUFFNFused``, ViT-g/14)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def swiglu_hidden(dim: int) -> int:
    """The SwiGLU-aligned hidden width (int(dim·4·2/3) + 7) // 8 · 8."""
    return (int(dim * MLP_RATIO * 2 / 3) + 7) // 8 * 8


class DinoBlock(nn.Module):
    """Pre-LN block with LayerScale: x += ls1(attn(norm1(x))); x += ls2(mlp(norm2(x)))."""

    def __init__(self, dim: int, num_heads: int, ffn_layer: str = "mlp"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        if ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFN(dim, swiglu_hidden(dim))
        elif ffn_layer == "mlp":
            self.mlp = Mlp(dim, int(dim * MLP_RATIO))
        else:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    """DINOv2 ViT-*/14. ``forward`` returns, for each block in
    ``out_indices`` (all blocks' last if empty), (patches (B, D, h0, w0),
    cls (B, D)); ``final_norm`` applies ``norm`` to them. ``norm`` is built
    either way, so that its parameters stay in the state dict."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16, ffn_layer: str = "mlp",
                 pretrain_grid: int = 37):
        super().__init__()
        self.embed_dim, self.depth = embed_dim, depth
        self.patch_embed = PatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid * pretrain_grid + 1, embed_dim))
        self.blocks = nn.ModuleList(
            [DinoBlock(embed_dim, num_heads, ffn_layer) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, out_indices: Sequence[int] = (), final_norm: bool = False
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        b, _, h, w = x.shape
        if h % PATCH_SIZE or w % PATCH_SIZE:
            raise ValueError(f"input {h}x{w} is not a multiple of the patch size {PATCH_SIZE}; center_pad it")
        h0, w0 = h // PATCH_SIZE, w // PATCH_SIZE
        tok = self.patch_embed(x)
        cls = self.cls_token.to(tok.dtype).expand(b, -1, -1)
        pos = interpolate_pos_embed(self.pos_embed, (h0, w0))
        tok = torch.cat([cls, tok], dim=1) + pos.to(tok.dtype)
        indices = {int(i) % self.depth for i in out_indices}
        outs = []
        for i, blk in enumerate(self.blocks):
            tok = blk(tok)
            if i in indices:
                outs.append(tok)
        if not indices:
            outs = [tok]
        results = []
        for o in outs:
            if final_norm:
                o = self.norm(o)
            patches = o[:, 1:].reshape(b, h0, w0, self.embed_dim).permute(0, 3, 1, 2)
            results.append((patches, o[:, 0]))
        return results
