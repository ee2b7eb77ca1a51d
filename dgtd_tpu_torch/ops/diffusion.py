"""Depth-diffusion stencil in plane layout: the hand-written Hopper kernels
(``csrc/diffusion_stencil.cu`` forward, ``csrc/diffusion_stencil_bwd.cu``
backward) and their plain PyTorch versions.

Counterpart of ``dgtd_tpu/ops/diffusion_pallas.py::diffusion_pallas_v2_planes``
and its custom VJP. The forward kernel replaces the Pallas
``diffusion_step_pallas_v2``, the backward kernel both Pallas kernels of
``diffusion_step_bwd_pallas`` (one fused launch per step). Unlike the JAX
package, which keeps grids under 64 on fused XLA, the port launches them at
every grid size on CUDA. CPU tensors take the plain versions; a CUDA tensor
gets the kernels or an exception, never a plain version.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

#: launches of the forward kernel (one per step) and of the backward kernel
#: (one per step), for run-time proof that a path went through them; callers
#: reset them to 0 before the run they read
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def _kernel_fn(name: str, symbol: str, argtypes):
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _fwd_fn():
    return _kernel_fn("diffusion_stencil", "dgtd_diffusion_step", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def _bwd_fn():
    return _kernel_fn("diffusion_stencil_bwd", "dgtd_diffusion_step_bwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 accumulation, fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def diffusion_step_plain(x: torch.Tensor, w: torch.Tensor, kernel: int) -> torch.Tensor:
    """One stencil step as ``F.unfold``·w·sum, fp32 inside, stored in x's
    dtype. x (P, H, W), w (P, k², H, W)."""
    p, h, wd = x.shape
    acc = _acc_dtype(x.dtype)
    taps = F.unfold(x.to(acc).unsqueeze(1), kernel, padding=kernel // 2)
    return (taps.view(p, kernel * kernel, h, wd) * w.to(acc)).sum(1).to(x.dtype)


def diffusion_planes_plain(
    x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int
) -> torch.Tensor:
    """``steps`` stencil steps, each step's result stored in x's dtype."""
    for _ in range(steps):
        x = diffusion_step_plain(x, w, kernel)
    return x


def diffusion_step_bwd_plain(
    g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's backward: g (P, H, W) = dL/d(step output), x the step
    input, w (P, k², H, W). Returns (dx in x's dtype, dw in fp32): dx is
    ``F.fold`` (col2im, the adjoint of the forward's unfold) of g·w, dw is
    g·unfold(x)."""
    p, h, wd = x.shape
    kk, pad = kernel * kernel, kernel // 2
    acc = _acc_dtype(x.dtype)
    gf = g.to(acc).unsqueeze(1)
    dx = F.fold((gf * w.to(acc)).view(p, kk, h * wd), (h, wd), kernel, padding=pad)
    taps = F.unfold(x.to(acc).unsqueeze(1), kernel, padding=pad).view(p, kk, h, wd)
    return dx.view(p, h, wd).to(x.dtype), gf * taps


def diffusion_planes_bwd_plain(
    g: torch.Tensor, xs: Sequence[torch.Tensor], w: torch.Tensor, kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``len(xs)`` steps whose inputs were ``xs``, chained in
    reverse: dx rounds to x's dtype each step (as the forward does), dw is
    summed in fp32 and cast to w's dtype once."""
    dw = None
    for x in reversed(xs):
        g, dws = diffusion_step_bwd_plain(g, x, w, kernel)
        dw = dws if dw is None else dw + dws
    if dw is None:
        dw = torch.zeros(w.shape, dtype=_acc_dtype(w.dtype), device=w.device)
    return g, dw.to(w.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> None:
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


def _device_and_stream(x: torch.Tensor):
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(x.device).cuda_stream


def _forward_steps(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int, keep: bool) -> List[torch.Tensor]:
    """Run the steps; returns [x, out_1, ..., out_steps] when ``keep`` (the
    step inputs are saved for backward), else [x, out_steps]."""
    global LAUNCHES
    if x.device.type == "cpu" and w.device.type == "cpu":
        outs = [x]
        for _ in range(steps):
            outs.append(diffusion_step_plain(outs[-1], w, kernel))
        return outs if keep else [x, outs[-1]]
    _check(x, w, kernel, steps)
    if steps == 0:
        return [x, x]
    fn = _fwd_fn()
    p, h, wd = x.shape
    code = _DTYPE_CODES[x.dtype]
    dev, stream = _device_and_stream(x)
    bufs = None if keep else [torch.empty_like(x) for _ in range(min(steps, 2))]
    outs = [x]
    for s in range(steps):
        dst = torch.empty_like(x) if keep else bufs[s % 2]
        rc = fn(outs[-1].data_ptr(), w.data_ptr(), dst.data_ptr(), p, h, wd, kernel, code, dev, stream)
        if rc != 0:
            raise RuntimeError(f"diffusion stencil launch failed: cudaError {rc}")
        LAUNCHES += 1
        outs.append(dst)
    return outs if keep else [x, outs[-1]]


def diffusion_planes_bwd(
    g: torch.Tensor, xs: Sequence[torch.Tensor], w: torch.Tensor, kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``len(xs)`` steps whose inputs were ``xs``: (dx, dw). On
    CUDA one launch of the backward kernel per step, dw summed in fp32 and
    cast to w's dtype by the last launch; on the CPU the plain version."""
    global BWD_LAUNCHES
    if g.device.type == "cpu" and w.device.type == "cpu":
        return diffusion_planes_bwd_plain(g, xs, w, kernel)
    _check(g, w, kernel, len(xs))
    for x in xs:
        if x.device != g.device or x.dtype != g.dtype or x.shape != g.shape or not x.is_contiguous():
            raise ValueError("diffusion_planes_bwd needs step inputs like g: one device, dtype and shape, contiguous")
    if not xs:
        return g, torch.zeros_like(w)
    fn = _bwd_fn()
    p, h, wd = g.shape
    code = _DTYPE_CODES[g.dtype]
    dev, stream = _device_and_stream(g)
    dw_out = torch.empty_like(w)
    # fp32 weights sum dw in place in the output; bf16 weights in an fp32
    # buffer that the last step reads once and rounds into the output
    dw_acc = dw_out if w.dtype == torch.float32 else torch.empty(w.shape, dtype=torch.float32, device=w.device)
    dw_in = None
    for i, x in enumerate(reversed(xs)):
        last = i == len(xs) - 1
        dst = dw_out if last else dw_acc
        dx = torch.empty_like(g)
        rc = fn(g.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
                None if dw_in is None else dw_in.data_ptr(), dst.data_ptr(),
                p, h, wd, kernel, code, _DTYPE_CODES[dst.dtype], dev, stream)
        if rc != 0:
            raise RuntimeError(f"diffusion stencil backward launch failed: cudaError {rc}")
        BWD_LAUNCHES += 1
        g, dw_in = dx, dw_acc
    return g, dw_out


class DiffusionPlanesFn(torch.autograd.Function):
    """``steps`` stencil steps with their backward: forward saves every
    step's input and w, backward runs the steps in reverse. The custom_fwd/
    custom_bwd pair makes backward see forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, kernel, steps):
        keep = any(ctx.needs_input_grad[:2])
        outs = _forward_steps(x, w, kernel, steps, keep)
        ctx.kernel = kernel
        if keep:
            ctx.save_for_backward(w, *outs[:-1])
        # a Function's output must not be its input unchanged (steps == 0)
        return outs[-1].clone() if outs[-1] is x else outs[-1]

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        w, *xs = ctx.saved_tensors
        dx, dw = diffusion_planes_bwd(g.contiguous(), xs, w, ctx.kernel)
        return dx, dw, None, None


def diffusion_planes(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` affinity-weighted stencil steps in plane layout, with their
    gradient.

    x (P, H, W) and w (P, k², H, W), w already normalized, P = B·C. On CUDA
    each step is one launch of the forward kernel and, in backward, one of
    the backward kernel; on the CPU the plain versions run."""
    return DiffusionPlanesFn.apply(x, w, kernel, steps)
