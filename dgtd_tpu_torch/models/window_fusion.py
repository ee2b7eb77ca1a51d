"""Windowed cross-attention fusion (counterpart of
``dgtd_tpu/models/window_fusion.py``): the reference's ``WindowFusion`` and
``new_WindowFusion`` with their window helpers and the MViT decomposed
relative position bias. No model calls them, in the reference or here.

The modules take NCHW maps, as the port's other modules do; the window
helpers work on (B, H, W, C), as Swin's do. The attention is the plain
``softmax(q·kᵀ + bias)·v``, the softmax in fp32 (the JAX version is jnp,
not a Pallas kernel).

Under a data×space layout (``parallel/space.py``) x and y are this rank's
bands of maps of global height ``h``, and so are the outputs; each module
computes the whole map's answer, as the JAX package's traced under a mesh
does. ``WindowFusion`` runs on the gathered maps, so that its padding and
windows are the whole map's, and keeps its band of the result.
``NewWindowFusion`` keeps its queries on the band and gathers every key and
value.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import space
from .layers import linear


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nWin, win, win, C); H and W divisible by ``win``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    b = windows.shape[0] // ((h // win) * (w // win))
    x = windows.reshape(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _rel_index(q_n: int, k_n: int) -> np.ndarray:
    q_ratio, k_ratio = max(k_n / q_n, 1.0), max(q_n / k_n, 1.0)
    dist = np.arange(q_n)[:, None] * q_ratio - np.arange(k_n)[None, :] * k_ratio + (k_n - 1) * k_ratio
    return dist.astype(np.int64)


def rel_pos_spatial_bias(q: torch.Tensor, q_shape: Tuple[int, int], k_shape: Tuple[int, int],
                         rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor) -> torch.Tensor:
    """MViT's decomposed relative position bias: q (B, heads, q_h·q_w, dim)
    -> bias (B, heads, q_h·q_w, k_h·k_w)."""
    (q_h, q_w), (k_h, k_w) = q_shape, k_shape
    rh = rel_pos_h[torch.as_tensor(_rel_index(q_h, k_h), device=q.device)]  # (q_h, k_h, dim)
    rw = rel_pos_w[torch.as_tensor(_rel_index(q_w, k_w), device=q.device)]  # (q_w, k_w, dim)
    b, heads, _, dim = q.shape
    r_q = q.reshape(b, heads, q_h, q_w, dim)
    rel_h = torch.einsum("byhwc,hkc->byhwk", r_q, rh.to(q.dtype))
    rel_w = torch.einsum("byhwc,wkc->byhwk", r_q, rw.to(q.dtype))
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, heads, q_h * q_w, k_h * k_w)


class WindowFusion(nn.Module):
    """Windowed cross-attention with relative position bias: ``x`` gives the
    queries, ``y`` the keys and values; maps are zero-padded at the bottom
    and right to whole windows. forward(x, y, h=None) NCHW (B, dim, H, W)
    -> (attended·y + y, sigmoid(attended)); ``h``: the maps' global height
    under a data×space layout."""

    def __init__(self, dim: int, window: int = 10, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * window - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * window - 1, hd))
        self.q = linear(dim, dim, bias=qkv_bias)
        self.kv = linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = linear(dim, dim)

    def forward(self, x, y, h=None):
        if not space.split():
            return self._fuse(x, y)
        if h is None:
            raise ValueError("under a data×space layout WindowFusion needs the maps' global height")
        space.count("replicated")
        out, gate = self._fuse(space.gather_rows(x, h), space.gather_rows(y, h))
        return space.band_rows(out), space.band_rows(gate)

    def _fuse(self, x, y):
        b, c, h, w = x.shape
        win, nh = self.window, self.num_heads
        hd = c // nh
        pad_b, pad_r = (win - h % win) % win, (win - w % win) % win
        xp = F.pad(x, (0, pad_r, 0, pad_b)).permute(0, 2, 3, 1)
        yp = F.pad(y, (0, pad_r, 0, pad_b)).permute(0, 2, 3, 1)
        hp, wp = h + pad_b, w + pad_r
        n = win * win
        xw = window_partition(xp, win).reshape(-1, n, c)
        yw = window_partition(yp, win).reshape(-1, n, c)
        bw = xw.shape[0]
        q = self.q(xw).reshape(bw, n, nh, hd).transpose(1, 2) * hd ** -0.5
        k, v = self.kv(yw).reshape(bw, n, 2, nh, hd).permute(2, 0, 3, 1, 4)
        attn = q @ k.transpose(-2, -1) + rel_pos_spatial_bias(q, (win, win), (win, win), self.rel_pos_h,
                                                             self.rel_pos_w)
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = self.proj((attn @ v).transpose(1, 2).reshape(bw, n, c))
        out = window_reverse(out.reshape(-1, win, win, c), win, hp, wp)[:, :h, :w].permute(0, 3, 1, 2)
        return out * y + y, torch.sigmoid(out)


class NewWindowFusion(nn.Module):
    """Global cross-attention fusion (the reference's ``new_WindowFusion``):
    queries and keys from ``x``, values from ``y``; forward(x, y, h=None)
    NCHW -> attended + x + y; ``h``: the maps' global height under a
    data×space layout."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qk = linear(dim, 2 * dim, bias=qkv_bias)
        self.v = linear(dim, dim, bias=qkv_bias)
        self.proj = linear(dim, dim)

    def forward(self, x, y, h=None):
        b, c, hb, w = x.shape
        n, nh = hb * w, self.num_heads
        hd = c // nh
        xt, yt = x.flatten(2).transpose(1, 2), y.flatten(2).transpose(1, 2)
        q, k = self.qk(xt).reshape(b, n, 2, nh, hd).unbind(2)
        v = self.v(yt).reshape(b, n, nh, hd)
        if space.split():
            if h is None:
                raise ValueError("under a data×space layout NewWindowFusion needs the maps' global height")
            space.count("banded" if space.banded(h) else "replicated")
            # every key and value: the whole map's tokens
            k, v = space.gather_rows(k, h, dim=1), space.gather_rows(v, h, dim=1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        attn = ((q * hd ** -0.5) @ k.transpose(-2, -1)).float().softmax(dim=-1).to(v.dtype)
        out = self.proj((attn @ v).transpose(1, 2).reshape(b, n, c)) + xt + yt
        return out.transpose(1, 2).reshape(b, c, hb, w)
