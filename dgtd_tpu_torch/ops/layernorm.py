"""LayerNorm over the last axis: the hand-written Hopper kernel
(``csrc/layernorm.cu``) and its plain PyTorch version.

Counterpart of ``dgtd_tpu/ops/layernorm_pallas.py::layer_norm_pallas``: the
forward kernel replaces the Pallas kernel, the backward is autograd through
the plain version (the JAX backward is the VJP of ``_ln_reference``). Like
the JAX kernel it is standalone: no model of the port calls it (the models
use ``models/layers.py::LayerNorm``). CPU tensors take the plain version; a
CUDA tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the forward kernel (one per call), for run-time proof that a
#: path went through it; callers reset it to 0 before the run they read
LAUNCHES = 0

#: the longest row the kernel takes: C fp32 values in a block's shared memory
MAX_C = 232448 // 4


def _fn():
    return _build.function("layernorm", "dgtd_layer_norm", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``_ln_reference``: fp32 mean, then the variance of (x - mean); scale
    and bias in fp32; the output in x's dtype (fp64 stays fp64)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(acc) + bias.to(acc)).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device or bias.device != x.device:
        raise ValueError(f"layer_norm needs x, scale and bias on one CUDA device, got {x.device}, {scale.device}, {bias.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"layer_norm takes float32 or bfloat16 x, got {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"layer_norm takes x (..., C) and scale, bias (C,); got {tuple(x.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"layer_norm takes 1 <= C <= {MAX_C}, got {c}")
    if not x.is_contiguous():
        raise ValueError("layer_norm needs a contiguous x")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward without autograd. On CUDA one launch of the kernel; on the
    CPU the plain version."""
    global LAUNCHES
    if x.device.type == "cpu" and scale.device.type == "cpu" and bias.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check(x, scale, bias)
    out = torch.empty_like(x)
    c = x.shape[-1]
    dev, stream = _build.device_and_stream(x)
    sf, bf = scale.detach().float().contiguous(), bias.detach().float().contiguous()
    rc = _fn()(x.data_ptr(), sf.data_ptr(), bf.data_ptr(), out.data_ptr(), x.numel() // c, c, eps,
               _build.DTYPE_CODES[x.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


class LayerNormFn(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd through the plain version, on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, scale, bias)]
            out = layer_norm_plain(*ins, ctx.eps)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape), with its
    gradient; the output in x's dtype."""
    return LayerNormFn.apply(x, scale, bias, eps)
