"""Image ops in NCHW with PyTorch semantics (counterpart of
``dgtd_tpu/utils/image.py``).

The JAX package emulates ``F.interpolate``/``F.unfold`` with dense matrices
and slices; here the torch operators are the definition itself. Only the
legacy ``nearest`` rule and the FFT high-pass mask are spelled out, so their
index arithmetic matches the JAX side exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(
    x: torch.Tensor,
    size: Tuple[int, int],
    align_corners: bool = False,
    exact: bool = True,
) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to ``size=(H, W)`` (``F.interpolate``,
    ``antialias=False``). ``exact=True`` computes in fp32 and casts back, as
    the JAX ``exact`` path does; ``exact=False`` stays in the input dtype."""
    out_h, out_w = int(size[0]), int(size[1])
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    src = x.float() if exact else x
    y = F.interpolate(src, size=(out_h, out_w), mode="bilinear", align_corners=align_corners)
    return y.to(x.dtype)


def resize_scale(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(scale_factor=scale)``'s output size, floor(size·scale),
    with the source indices of a resize to that size (as the JAX package
    does)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (int(np.floor(h * scale)), int(np.floor(w * scale))), align_corners)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Legacy ``nearest``: src index = floor(dst * in / out)."""
    h, w = x.shape[-2:]
    out_h, out_w = int(size[0]), int(size[1])
    if (h, w) == (out_h, out_w):
        return x
    rows = np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64)
    cols = np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64)
    rows_t = torch.as_tensor(rows, device=x.device)
    cols_t = torch.as_tensor(cols, device=x.device)
    return x.index_select(-2, rows_t).index_select(-1, cols_t)


def extract_patches(x: torch.Tensor, kernel: int, padding: int) -> torch.Tensor:
    """im2col for stride-1 stencils: NCHW -> (B, C, k*k, H', W') in
    ``F.unfold`` tap order (row-major over the window), zero padding."""
    b, c, h, w = x.shape
    out_h = h + 2 * padding - kernel + 1
    out_w = w + 2 * padding - kernel + 1
    cols = F.unfold(x, kernel, padding=padding)  # (B, C*k*k, L)
    return cols.view(b, c, kernel * kernel, out_h, out_w)


def avg_pool(x: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``F.avg_pool2d`` with ``count_include_pad=True``, fp32 inside, in x's
    dtype."""
    y = F.avg_pool2d(x.float(), kernel, stride, padding, count_include_pad=True)
    return y.to(x.dtype)


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool over the two spatial dims, padded with the dtype's minimum
    (any dtype, integers too)."""
    lo = torch.finfo(x.dtype).min if x.is_floating_point() else torch.iinfo(x.dtype).min
    if padding:
        x = F.pad(x, (padding, padding, padding, padding), value=lo)
    return x.unfold(-2, kernel, stride).unfold(-2, kernel, stride).amax(dim=(-2, -1))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection pad of the two spatial dims (``nn.ReflectionPad2d``)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def normalize_01(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Min-max normalize with ONE min and max over the whole tensor (the
    whole batch, not per image), as the reference's loss does."""
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + eps)


def fft_high_pass(x: torch.Tensor, rate: float) -> torch.Tensor:
    """FFT high-pass texture: zero a centered low-frequency square of side
    ``2 * int(sqrt(H*W*rate)//2)`` of the shifted spectrum (norm='forward'),
    inverse-transform, return ``abs(real)``. NCHW in/out, fp32 inside."""
    h, w = x.shape[-2:]
    line = int((h * w * rate) ** 0.5 // 2)
    keep = np.ones((h, w), dtype=np.float32)
    keep[h // 2 - line : h // 2 + line, w // 2 - line : w // 2 + line] = 0.0
    keep_t = torch.as_tensor(np.fft.ifftshift(keep), device=x.device)
    spec = torch.fft.fft2(x.float(), dim=(-2, -1), norm="forward") * keep_t
    inv = torch.fft.ifft2(spec, dim=(-2, -1), norm="forward").real
    return inv.abs().to(x.dtype)
