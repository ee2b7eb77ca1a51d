"""Depth-diffusion stencil in plane layout: the hand-written Hopper kernel
(``csrc/diffusion_stencil.cu``) and its plain PyTorch version.

Counterpart of ``dgtd_tpu/ops/diffusion_pallas.py::diffusion_pallas_v2_planes``
(forward). The kernel replaces the Pallas ``diffusion_step_pallas_v2``; unlike
the JAX package, which keeps grids under 64 on fused XLA, the port launches it
at every grid size on CUDA. CPU tensors take the plain version; a CUDA tensor
gets the kernel or an exception, never the plain version.

The forward only: the backward kernels (``diffusion_step_bwd_pallas``) arrive
with the training slice as a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

#: launches of the CUDA kernel (one per step), for run-time proof that a path
#: went through it; callers reset it to 0 before the run they read
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("diffusion_stencil").dgtd_diffusion_step
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def diffusion_planes_plain(
    x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int
) -> torch.Tensor:
    """``steps`` stencil steps as ``F.unfold``·w·sum, fp32 inside, each
    step's result stored in x's dtype. x (P, H, W), w (P, k², H, W)."""
    p, h, wd = x.shape
    wf = w.float()
    for _ in range(steps):
        taps = F.unfold(x.float().unsqueeze(1), kernel, padding=kernel // 2)
        x = (taps.view(p, kernel * kernel, h, wd) * wf).sum(1).to(x.dtype)
    return x


def _check(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "diffusion_planes on CUDA is forward-only: its backward kernels "
            "(diffusion_step_bwd_pallas) come with the training slice"
        )
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"diffusion_planes needs x and w on one CUDA device, got {x.device} and {w.device}"
        )
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"diffusion_planes takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if kernel < 1 or kernel % 2 == 0 or steps < 0:
        raise ValueError(f"need an odd kernel >= 1 and steps >= 0, got kernel={kernel}, steps={steps}")
    if x.dim() != 3 or tuple(w.shape) != (x.shape[0], kernel * kernel, x.shape[1], x.shape[2]):
        raise ValueError(
            f"diffusion_planes takes x (P, H, W) and w (P, k², H, W); got {tuple(x.shape)} and {tuple(w.shape)} for k={kernel}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("diffusion_planes needs contiguous x and w")


def diffusion_planes(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` affinity-weighted stencil steps in plane layout.

    x (P, H, W) and w (P, k², H, W), w already normalized, P = B·C. On CUDA
    each step is one launch of the Hopper kernel; on the CPU the plain
    version runs."""
    global LAUNCHES
    if x.device.type == "cpu" and w.device.type == "cpu":
        return diffusion_planes_plain(x, w, kernel, steps)
    _check(x, w, kernel, steps)
    if steps == 0:
        return x
    fn = _kernel_fn()
    p, h, wd = x.shape
    code = _DTYPE_CODES[x.dtype]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bufs = [torch.empty_like(x) for _ in range(min(steps, 2))]
    src = x
    for s in range(steps):
        dst = bufs[s % 2]
        rc = fn(src.data_ptr(), w.data_ptr(), dst.data_ptr(), p, h, wd, kernel, code, dev, stream)
        if rc != 0:
            raise RuntimeError(f"diffusion stencil launch failed: cudaError {rc}")
        LAUNCHES += 1
        src = dst
    return src
