"""LayerNorm over the last axis: the hand-written Hopper kernel
(``csrc/layernorm.cu``) and its plain PyTorch version.

Counterpart of ``dgtd_tpu/ops/layernorm_pallas.py::layer_norm_pallas``: the
forward kernel replaces the Pallas kernel, the backward is autograd through
the plain version (the JAX backward is the VJP of ``_ln_reference``). Like
the JAX kernel it is standalone: no model of the port calls it (the models
use ``models/layers.py::LayerNorm``). CPU tensors take the plain version; a
CUDA tensor gets the kernel or an exception. The forward is the
``torch.library`` custom op ``dgtd_torch::layer_norm``. The kernel has three routes,
picked by :func:`ln_route` (the lane-group route with 16-byte accesses, the
scalar warp route, the block route).
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


#: the longest row the scalar and lane-group routes take; longer rows go to
#: the block route
WARP_MAX_C = 1024
ROUTES = ("group", "scalar", "block")


def ln_route(c: int, dtype: torch.dtype, x_addr: int = 0, out_addr: int = 0) -> str:
    """Which kernel a call takes on CUDA, as ``csrc/layernorm.cu::ln_route``
    decides it from C, the element size and the addresses of x and the
    output: "group" (a row on a group of lanes with 16-byte accesses) where
    C <= 1024, a row is a multiple of 16 bytes and both addresses are on a
    16-byte boundary; "scalar" (a warp a row, scalar accesses) for the other
    rows up to 1024; "block" (a block a row) beyond."""
    if c > WARP_MAX_C:
        return "block"
    if c * (torch.finfo(dtype).bits // 8) % 16 or x_addr % 16 or out_addr % 16:
        return "scalar"
    return "group"


def ln_group_shape(c: int, dtype: torch.dtype) -> tuple:
    """(G, VPL) of the group route: the lanes a row takes (its 16-byte
    vectors rounded up to a power of two, at most 32) and the vectors a lane
    holds (rounded up to a power of two), as the kernel's template
    instantiations take them."""
    nvec = c * (torch.finfo(dtype).bits // 8) // 16
    lanes = 1
    while lanes < min(nvec, 32):
        lanes *= 2
    vpl = 1
    while lanes * vpl < nvec:
        vpl *= 2
    return lanes, vpl


def kernel_route(c: int, dtype: torch.dtype, x_addr: int, out_addr: int) -> str:
    """The route the built kernel reports for these arguments (the card's
    machine only: it builds the library)."""
    fn = _build.function("layernorm", "dgtd_layer_norm_route",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    return ROUTES[fn(c, _build.DTYPE_CODES[dtype], x_addr, out_addr)]


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


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads scale and bias: fp32 and contiguous, converted
    only when it is not already."""
    t = t.detach()
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, out: torch.Tensor, eps: float) -> None:
    """One launch of the kernel into ``out`` (x's shape and dtype, contiguous):
    x, scale and bias as :func:`layer_norm_fwd` checks them, scale and bias
    fp32 and contiguous."""
    global LAUNCHES
    c = x.shape[-1]
    dev, stream = _build.device_and_stream(x)
    rc = _fn()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // c, c, eps,
               _build.DTYPE_CODES[x.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm launch failed: cudaError {rc}")
    LAUNCHES += 1


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward without autograd, through the ``dgtd_torch::layer_norm``
    op. On CUDA one launch of the kernel; on the CPU the plain version. A
    tensor on neither, or a CUDA x that is not contiguous, raises here (the
    op itself takes any strides)."""
    on_cpu = all(t.device.type == "cpu" for t in (x, scale, bias))
    if not (on_cpu or (all(t.device.type == "cuda" for t in (x, scale, bias)) and x.is_contiguous())):
        _check(x, scale, bias)
    return layer_norm_op(x, scale, bias, float(eps))


@torch.library.custom_op("dgtd_torch::layer_norm", mutates_args=(), device_types="cuda")
def layer_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm's forward as a ``torch.library`` op, so that
    ``torch.export`` can trace it: on CUDA one launch of the kernel (a
    launch that fails raises), on the CPU the plain version. x is made
    contiguous here: an exported program's strides are the trace's."""
    x = x.contiguous()
    _check(x, scale, bias)
    out = torch.empty_like(x)
    launch(x, _fp32(scale), _fp32(bias), out, eps)
    return out


@layer_norm_op.register_kernel("cpu")
def _layer_norm_cpu(x, scale, bias, eps):
    return layer_norm_plain(x, scale, bias, eps)


@layer_norm_op.register_fake
def _layer_norm_fake(x, scale, bias, eps):
    return torch.empty_like(x)


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
