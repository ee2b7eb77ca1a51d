"""The image operations, the diffusion stencil and the stochastic depth of
the reference, in NCHW and float32.

Resizes are PyTorch's bilinear ``F.interpolate`` (no antialias); the
texture's downsampling is the legacy ``nearest`` rule, source index
``floor(dst · in / out)``; the texture is the FFT high-pass of the paper's
prompt encoder. DropPath draws its keep mask from a generator seeded from
``(seed, step)`` alone, one draw of ``batch`` uniforms a call of a branch
whose rate is not 0, in the order the forward reaches the branches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    h, w = x.shape[-2:]
    rows = torch.as_tensor(np.floor(np.arange(size[0]) * (h / size[0])).astype(np.int64), device=x.device)
    cols = torch.as_tensor(np.floor(np.arange(size[1]) * (w / size[1])).astype(np.int64), device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def fft_high_pass(x: torch.Tensor, rate: float) -> torch.Tensor:
    """|real(ifft2(fft2(x) with a centred low-frequency square of side
    2·floor(sqrt(H·W·rate)/2) of the shifted spectrum set to 0))|."""
    h, w = x.shape[-2:]
    half = int((h * w * rate) ** 0.5 // 2)
    keep = np.ones((h, w), np.float32)
    keep[h // 2 - half:h // 2 + half, w // 2 - half:w // 2 + half] = 0.0
    mask = torch.as_tensor(np.fft.ifftshift(keep), device=x.device)
    spec = torch.fft.fft2(x, dim=(-2, -1), norm="forward") * mask
    return torch.fft.ifft2(spec, dim=(-2, -1), norm="forward").real.abs()


def avg_pool(x: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=True)


def stencil(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` steps of the per-pixel affinity-weighted stencil on planes:
    x (P, H, W), w (P, k², H, W) in row-major tap order, zero outside the
    plane: x ← Σ_t w_t · shift_t(x)."""
    p, h, wd = x.shape
    pad = kernel // 2
    for _ in range(steps):
        xp = F.pad(x, (pad, pad, pad, pad))
        taps = torch.stack([xp[:, dy:dy + h, dx:dx + wd] for dy in range(kernel) for dx in range(kernel)], 1)
        x = (taps * w).sum(1)
    return x


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The stochastic depth's generator of train step ``step``: seeded from
    the two 32-bit words numpy's SeedSequence([seed, step]) gives."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def drop_path(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Per-sample stochastic depth: each sample kept with probability
    1 − rate and scaled by 1/(1 − rate); identity without a generator or at
    rate 0."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
