"""Depth-diffusion stencil: the hand-written Hopper kernels
(``csrc/diffusion_stencil.cu`` forward, ``csrc/diffusion_stencil_bwd.cu``
backward) and their plain PyTorch versions.

Plane layout is the counterpart of
``dgtd_tpu/ops/diffusion_pallas.py::diffusion_pallas_v2_planes`` and its
custom VJP. The forward kernel replaces the Pallas
``diffusion_step_pallas_v2``, the backward kernel both Pallas kernels of
``diffusion_step_bwd_pallas`` (one fused launch per step). Unlike the JAX
package, which keeps grids under 64 on fused XLA, the port launches them at
every grid size on CUDA.

NHWC is the counterpart of ``diffusion_pallas`` (x (B, H, W, C), weights
(B, H, W, C, k²), tap-major inside): its forward kernel, a second kernel in
``csrc/diffusion_stencil.cu``, replaces the Pallas ``diffusion_step_pallas``;
its backward moves g, the step inputs and w into plane layout and runs the
plane backward kernel (the JAX backward is the VJP of the jnp stencil).

CPU tensors take the plain versions; a CUDA tensor gets the kernels or an
exception, never a plain version.
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
#: launches of the NHWC forward kernel (one per step); its backward counts
#: in ``BWD_LAUNCHES``
NHWC_LAUNCHES = 0


def _fwd_fn():
    return _build.function("diffusion_stencil", "dgtd_diffusion_step", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def _bwd_fn():
    return _build.function("diffusion_stencil_bwd", "dgtd_diffusion_step_bwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def _nhwc_fn():
    return _build.function("diffusion_stencil", "dgtd_diffusion_step_nhwc", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"diffusion_planes takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if kernel < 1 or kernel % 2 == 0 or steps < 0:
        raise ValueError(f"need an odd kernel >= 1 and steps >= 0, got kernel={kernel}, steps={steps}")
    if x.dim() != 3 or tuple(w.shape) != (x.shape[0], kernel * kernel, x.shape[1], x.shape[2]):
        raise ValueError(
            f"diffusion_planes takes x (P, H, W) and w (P, k², H, W); got {tuple(x.shape)} and {tuple(w.shape)} for k={kernel}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("diffusion_planes needs contiguous x and w")


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
    code = _build.DTYPE_CODES[x.dtype]
    dev, stream = _build.device_and_stream(x)
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
    code = _build.DTYPE_CODES[g.dtype]
    dev, stream = _build.device_and_stream(g)
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
                p, h, wd, kernel, code, _build.DTYPE_CODES[dst.dtype], dev, stream)
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


# ---------------------------------------------------------------------------
# NHWC layout with tap-major weights
# ---------------------------------------------------------------------------


def to_tap_major(norm_weight: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C, k²) channel-major -> (B, H, W, k²·C) tap-major: tap t of
    channel c lands at t·C + c."""
    b, h, w, c, kk = norm_weight.shape
    return norm_weight.transpose(3, 4).reshape(b, h, w, kk * c)


def diffusion_step_nhwc_plain(x: torch.Tensor, w_tm: torch.Tensor, kernel: int) -> torch.Tensor:
    """One NHWC stencil step as ``F.unfold``·w·sum, fp32 inside, stored in
    x's dtype. x (B, H, W, C), w_tm (B, H, W, k²·C) tap-major."""
    b, h, wd, c = x.shape
    kk = kernel * kernel
    acc = _acc_dtype(x.dtype)
    taps = F.unfold(x.to(acc).permute(0, 3, 1, 2), kernel, padding=kernel // 2)  # row c·k² + t
    taps = taps.view(b, c, kk, h, wd).permute(0, 3, 4, 2, 1)  # (B, H, W, k², C)
    return (taps * w_tm.to(acc).view(b, h, wd, kk, c)).sum(3).to(x.dtype)


def diffusion_nhwc_plain(x: torch.Tensor, w_tm: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` NHWC stencil steps, each step's result stored in x's dtype."""
    for _ in range(steps):
        x = diffusion_step_nhwc_plain(x, w_tm, kernel)
    return x


def _check_nhwc(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"diffusion_nhwc needs x and w on one CUDA device, got {x.device} and {w.device}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"diffusion_nhwc takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if kernel < 1 or kernel % 2 == 0 or steps < 0:
        raise ValueError(f"need an odd kernel >= 1 and steps >= 0, got kernel={kernel}, steps={steps}")
    if x.dim() != 4 or tuple(w.shape) != (*x.shape[:3], kernel * kernel * x.shape[3]):
        raise ValueError(
            f"diffusion_nhwc takes x (B, H, W, C) and w (B, H, W, k²·C); got {tuple(x.shape)} and {tuple(w.shape)} for k={kernel}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("diffusion_nhwc needs contiguous x and w")


def _nhwc_forward_steps(x: torch.Tensor, w_tm: torch.Tensor, kernel: int, steps: int) -> List[torch.Tensor]:
    """Run the steps; returns [x, out_1, ..., out_steps]."""
    global NHWC_LAUNCHES
    if x.device.type == "cpu" and w_tm.device.type == "cpu":
        outs = [x]
        for _ in range(steps):
            outs.append(diffusion_step_nhwc_plain(outs[-1], w_tm, kernel))
        return outs
    _check_nhwc(x, w_tm, kernel, steps)
    fn = _nhwc_fn()
    b, h, wd, c = x.shape
    code = _build.DTYPE_CODES[x.dtype]
    dev, stream = _build.device_and_stream(x)
    outs = [x]
    for _ in range(steps):
        dst = torch.empty_like(x)
        rc = fn(outs[-1].data_ptr(), w_tm.data_ptr(), dst.data_ptr(), b, h, wd, c, kernel, code, dev, stream)
        if rc != 0:
            raise RuntimeError(f"NHWC diffusion stencil launch failed: cudaError {rc}")
        NHWC_LAUNCHES += 1
        outs.append(dst)
    return outs


def _nhwc_to_planes(t: torch.Tensor) -> torch.Tensor:
    b, h, w, c = t.shape
    return t.permute(0, 3, 1, 2).reshape(b * c, h, w)


class DiffusionNHWCFn(torch.autograd.Function):
    """``steps`` NHWC stencil steps on tap-major weights with their
    backward: the plane backward (kernel on CUDA, plain on the CPU) on g, the
    step inputs and w moved into plane layout; dw returns tap-major."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w_tm, kernel, steps):
        outs = _nhwc_forward_steps(x, w_tm, kernel, steps)
        ctx.kernel = kernel
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(w_tm, *outs[:-1])
        return outs[-1].clone() if outs[-1] is x else outs[-1]

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        w_tm, *xs = ctx.saved_tensors
        b, h, w, c = g.shape
        k = ctx.kernel
        kk = k * k
        wp = w_tm.view(b, h, w, kk, c).permute(0, 4, 3, 1, 2).reshape(b * c, kk, h, w)
        dxp, dwp = diffusion_planes_bwd(_nhwc_to_planes(g), [_nhwc_to_planes(t) for t in xs], wp, k)
        dx = dxp.view(b, c, h, w).permute(0, 2, 3, 1).contiguous()
        dw = dwp.view(b, c, kk, h, w).permute(0, 3, 4, 2, 1).reshape(b, h, w, kk * c)
        return dx, dw, None, None


def diffusion_nhwc_tap_major(x: torch.Tensor, w_tm: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` NHWC stencil steps on tap-major weights (B, H, W, k²·C),
    with their gradient. On CUDA each step is one launch of the NHWC forward
    kernel and, in backward, one of the plane backward kernel; on the CPU
    the plain versions run."""
    return DiffusionNHWCFn.apply(x, w_tm, kernel, steps)


def diffusion_nhwc(x: torch.Tensor, norm_weight: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` iterations of the normalized-affinity stencil in NHWC, the
    counterpart of ``dgtd_tpu``'s ``diffusion_pallas``: x (B, H, W, C),
    norm_weight (B, H, W, C, k²) normalized; the weights go tap-major once
    and the gradient returns to norm_weight's layout."""
    return diffusion_nhwc_tap_major(x, to_tap_major(norm_weight), kernel, steps)
