"""Image ops in NCHW with PyTorch semantics (counterpart of
``dgtd_tpu/utils/image.py``).

The JAX package emulates ``F.interpolate``/``F.unfold`` with dense matrices
and slices; here the torch operators are the definition itself. Only the
legacy ``nearest`` rule and the FFT high-pass mask are spelled out, so their
index arithmetic matches the JAX side exactly; their index and mask arrays
are made on a device once per shape (``core/device.py::constant``).

Under a data×space layout (``parallel/space.py``) the resizes, the FFT
high-pass and ``normalize_01`` take this rank's band of a level whose
global height is ``in_h``; sizes are global. They work on the whole level
(gather, compute, band), as XLA gathers the JAX package's resize einsums
and FFT; a bilinear resize by a whole factor down (``align_corners``
False) needs only the band's own rows and runs there. A level that every
rank holds whole (DQnet's cue grid and prompts) is resized by
:func:`resize_gathered` (gather once, keep the whole output) and
:func:`resize_to_band` (the whole resize, then the band's rows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import constant
from ..parallel import space


def resize_bilinear(
    x: torch.Tensor,
    size: Tuple[int, int],
    align_corners: bool = False,
    exact: bool = True,
    in_h: Optional[int] = None,
) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to ``size=(H, W)`` (``F.interpolate``,
    ``antialias=False``). ``exact=True`` computes in fp32 and casts back, as
    the JAX ``exact`` path does; ``exact=False`` stays in the input dtype.
    ``in_h``: x's global height under a data×space layout."""
    out_h, out_w = int(size[0]), int(size[1])
    if space.split():
        return _resize_level(x, out_h, out_w, align_corners, exact, in_h)
    return _resize(x, out_h, out_w, align_corners, exact)


def _resize(x, out_h, out_w, align_corners, exact):
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    src = x.float() if exact else x
    y = F.interpolate(src, size=(out_h, out_w), mode="bilinear", align_corners=align_corners)
    return y.to(x.dtype)


def _resize_level(x, out_h, out_w, align_corners, exact, in_h):
    """``resize_bilinear`` of the level whose band is x: on the band where
    it shrinks by a whole factor (each output row samples rows of its own
    band, at the same source offsets as on the whole level), else on the
    gathered level."""
    if in_h is None:
        raise ValueError("under a data×space layout resize_bilinear needs the input's global height (in_h)")
    if (in_h, x.shape[-1]) == (out_h, out_w):
        return x
    hb = x.shape[-2]
    if (not align_corners and space.banded(in_h) and space.banded(out_h) and in_h % out_h == 0
            and hb % (in_h // out_h) == 0):
        space.count("banded")
        return _resize(x, hb // (in_h // out_h), out_w, False, exact)
    return space.full_level(lambda full: _resize(full, out_h, out_w, align_corners, exact), x, in_h)


def resize_gathered(x: torch.Tensor, size: Tuple[int, int], in_h: Optional[int] = None) -> torch.Tensor:
    """``resize_bilinear(x, size)`` whose output every rank holds whole:
    under a data×space layout the level whose band is x (global height
    ``in_h``) is gathered and resized on every rank (counted ``full``)."""
    if space.split():
        space.count("full")
        x = space.gather_rows(x, _level_h(in_h, "resize_gathered"))
    return _resize(x, int(size[0]), int(size[1]), False, True)


def resize_to_band(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear(x, size, exact=False)`` of a level that every rank
    holds whole, then this rank's band of the result where its level is
    banded (``space.band_rows``): no exchange, and the band's rows are the
    whole resize's (counted ``replicated`` under a layout)."""
    if space.split():
        space.count("replicated")
    return space.band_rows(_resize(x, int(size[0]), int(size[1]), False, False))


def resize_scale(x: torch.Tensor, scale: float, align_corners: bool = False,
                 in_h: Optional[int] = None) -> torch.Tensor:
    """``F.interpolate(scale_factor=scale)``'s output size, floor(size·scale),
    with the source indices of a resize to that size (as the JAX package
    does). ``in_h``: x's global height under a data×space layout, whose
    floor(in_h·scale) is the output's global height."""
    h = x.shape[-2] if in_h is None else in_h
    w = x.shape[-1]
    return resize_bilinear(x, (int(np.floor(h * scale)), int(np.floor(w * scale))), align_corners, in_h=in_h)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int], in_h: Optional[int] = None) -> torch.Tensor:
    """Legacy ``nearest``: src index = floor(dst * in / out). ``in_h``: x's
    global height under a data×space layout (computed on the whole level)."""
    if space.split():
        return space.full_level(lambda full: _resize_nearest(full, size), x, _level_h(in_h, "resize_nearest"))
    return _resize_nearest(x, size)


def _level_h(in_h: Optional[int], what: str) -> int:
    if in_h is None:
        raise ValueError(f"under a data×space layout {what} needs the input's global height (in_h)")
    return in_h


def _resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = x.shape[-2:]
    out_h, out_w = int(size[0]), int(size[1])
    if (h, w) == (out_h, out_w):
        return x
    rows = constant(("nearest_index", h, out_h), x.device, lambda: _nearest_index(h, out_h))
    cols = constant(("nearest_index", w, out_w), x.device, lambda: _nearest_index(w, out_w))
    return x.index_select(-2, rows).index_select(-1, cols)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The legacy ``nearest`` source index of each of ``n_out`` outputs."""
    return np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)


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
    whole batch, not per image), as the reference's loss does; under a
    data×space layout the whole batch's, over every band and row."""
    lo, hi = space.global_min_max(x)
    return (x - lo) / (hi - lo + eps)


def fft_high_pass(x: torch.Tensor, rate: float, in_h: Optional[int] = None) -> torch.Tensor:
    """FFT high-pass texture: zero a centered low-frequency square of side
    ``2 * int(sqrt(H*W*rate)//2)`` of the shifted spectrum (norm='forward'),
    inverse-transform, return ``abs(real)``. NCHW in/out, fp32 inside.
    ``in_h``: x's global height under a data×space layout (computed on the
    whole level)."""
    if space.split():
        return space.full_level(lambda full: _fft_high_pass(full, rate), x, _level_h(in_h, "fft_high_pass"))
    return _fft_high_pass(x, rate)


def _fft_high_pass(x: torch.Tensor, rate: float) -> torch.Tensor:
    h, w = x.shape[-2:]
    keep = constant(("fft_high_pass", h, w, rate), x.device, lambda: _high_pass_keep(h, w, rate))
    spec = torch.fft.fft2(x.float(), dim=(-2, -1), norm="forward") * keep
    inv = torch.fft.ifft2(spec, dim=(-2, -1), norm="forward").real
    return inv.abs().to(x.dtype)


def _high_pass_keep(h: int, w: int, rate: float) -> np.ndarray:
    """The unshifted spectrum's mask of :func:`fft_high_pass`: 0 on the
    centered low-frequency square, 1 elsewhere."""
    line = int((h * w * rate) ** 0.5 // 2)
    keep = np.ones((h, w), dtype=np.float32)
    keep[h // 2 - line : h // 2 + line, w // 2 - line : w // 2 + line] = 0.0
    return np.fft.ifftshift(keep)
