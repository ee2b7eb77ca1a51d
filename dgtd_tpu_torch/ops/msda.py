"""Multi-scale deformable attention: the hand-written Hopper kernels
(``csrc/msda_fwd.cu`` forward, ``csrc/msda_bwd.cu`` dValue and
dLocation/dWeight), their plain PyTorch versions, the autograd op and the
``MSDeformAttn`` layer.

Counterpart of ``dgtd_tpu/ops/msda.py``: the forward kernel replaces the
Pallas ``ms_deform_attn_pallas_fwd``, the two backward kernels
``ms_deform_attn_pallas_dvalue`` and ``ms_deform_attn_pallas_dlocw``; each is
one launch per call, every level inside it. No model of the repository calls
the layer; it is the repository's Deformable-DETR surface.

Tensor contract (as the JAX package's):
  value:           (N, S, M, D), S = sum(H_l * W_l), levels in order along S
  spatial_shapes:  static sequence of (H_l, W_l)
  loc:             (N, Lq, M, L, P, 2) in (x, y) order, [0, 1] inside a level
  aw:              (N, Lq, M, L, P)
  output:          (N, Lq, M * D) in value's dtype

Bilinear sampling follows ``F.grid_sample(align_corners=False,
padding_mode='zeros')``: src = loc * size - 0.5, out-of-range corners
contribute zero. ``loc`` and ``aw`` are upcast to fp32 at the op's boundary
and the gradients cast back to the caller's dtypes. CPU tensors take the
plain versions; a CUDA tensor gets the kernels or an exception.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import init_parameters, linear
from . import _build

#: launches of the forward, dValue and dLocation/dWeight kernels (one each
#: per call), for run-time proof that a path went through them; callers
#: reset them to 0 before the run they read
LAUNCHES = 0
DVALUE_LAUNCHES = 0
DLOCW_LAUNCHES = 0

MAX_LEVELS = 16  # MSDA_MAX_LEVELS in the CUDA sources

_COMMON_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _fwd_fn():
    return _build.function("msda_fwd", "dgtd_msda_fwd", [ctypes.c_void_p] * 4 + _COMMON_ARGS)


def _dvalue_fn():
    return _build.function("msda_bwd", "dgtd_msda_dvalue", [ctypes.c_void_p] * 4 + _COMMON_ARGS)


def _dlocw_fn():
    return _build.function("msda_bwd", "dgtd_msda_dlocw", [ctypes.c_void_p] * 6 + _COMMON_ARGS)


Shapes = Tuple[Tuple[int, int], ...]


def _static_shapes(spatial_shapes) -> Shapes:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _acc_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """fp32 arithmetic, fp64 where an input is fp64 (gradcheck)."""
    acc = torch.float32
    for dt in dtypes:
        acc = torch.promote_types(acc, dt)
    return acc


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracles
# ---------------------------------------------------------------------------


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes, loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """Gather-based MSDA, a mirror of ``ms_deform_attn_reference``: fp32 (or
    fp64) arithmetic, the output in value's dtype. Differentiable."""
    shapes = _static_shapes(spatial_shapes)
    n, s, m, d = value.shape
    _, lq, _, _, p, _ = loc.shape
    acc = _acc_dtype(value.dtype, loc.dtype, aw.dtype)
    out = torch.zeros((n, m, lq, d), dtype=acc, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(shapes):
        v = value[:, start : start + h * w].to(acc).permute(0, 2, 1, 3)  # (N, M, HW, D)
        start += h * w
        x = loc[:, :, :, lid, :, 0].to(acc) * w - 0.5  # (N, Lq, M, P)
        y = loc[:, :, :, lid, :, 1].to(acc) * h - 0.5
        a = aw[:, :, :, lid].to(acc)
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        sampled = 0.0
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi, yi = x0i + dx, y0i + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).permute(0, 2, 1, 3).reshape(n, m, lq * p)
                corner = torch.gather(v, 2, flat[..., None].expand(n, m, lq * p, d))
                wgt = (wx * wy * valid * a).permute(0, 2, 1, 3).reshape(n, m, lq * p, 1)
                sampled = sampled + corner * wgt
        out = out + sampled.view(n, m, lq, p, d).sum(3)
    return out.permute(0, 2, 1, 3).reshape(n, lq, m * d).to(value.dtype)


def ms_deform_attn_dvalue_plain(g, value, spatial_shapes, loc, aw) -> torch.Tensor:
    """dL/dvalue for the output gradient g (N, Lq, M*D): (N, S, M, D) in fp32
    (fp64 for fp64 inputs), from ``torch.autograd.grad`` of the plain
    forward."""
    acc = _acc_dtype(value.dtype, loc.dtype, aw.dtype)
    with torch.enable_grad():
        v = value.detach().to(acc).requires_grad_()
        out = ms_deform_attn_plain(v, spatial_shapes, loc.detach(), aw.detach())
        (dv,) = torch.autograd.grad(out, v, g.to(acc))
    return dv


def ms_deform_attn_dlocw_plain(g, value, spatial_shapes, loc, aw) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dloc, dL/daw) for the output gradient g, in fp32 (fp64 for fp64
    inputs), value read as fp32; from ``torch.autograd.grad`` of the plain
    forward."""
    acc = _acc_dtype(value.dtype, loc.dtype, aw.dtype)
    with torch.enable_grad():
        sl = loc.detach().to(acc).requires_grad_()
        a = aw.detach().to(acc).requires_grad_()
        out = ms_deform_attn_plain(value.detach().to(acc), spatial_shapes, sl, a)
        dloc, daw = torch.autograd.grad(out, (sl, a), g.to(acc))
    return dloc, daw


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor, aw: torch.Tensor,
           g: Optional[torch.Tensor] = None) -> None:
    ts = (value, loc, aw) + (() if g is None else (g,))
    if value.device.type != "cuda" or any(t.device != value.device for t in ts):
        raise ValueError(f"ms_deform_attn needs every tensor on one CUDA device, got {[str(t.device) for t in ts]}")
    if value.dtype not in _build.DTYPE_CODES or loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError(
            f"ms_deform_attn takes float32 or bfloat16 value and float32 loc and aw, got {value.dtype}, {loc.dtype}, {aw.dtype}"
        )
    if value.dim() != 4 or loc.dim() != 6:
        raise ValueError(f"ms_deform_attn takes value (N, S, M, D) and loc (N, Lq, M, L, P, 2), got {tuple(value.shape)}, {tuple(loc.shape)}")
    n, s, m, d = value.shape
    _, lq, _, n_levels, p, _ = loc.shape
    if tuple(loc.shape) != (n, lq, m, n_levels, p, 2) or tuple(aw.shape) != (n, lq, m, n_levels, p):
        raise ValueError(f"ms_deform_attn: loc {tuple(loc.shape)} and aw {tuple(aw.shape)} do not match value {tuple(value.shape)}")
    if n_levels != len(shapes) or not 1 <= n_levels <= MAX_LEVELS or sum(h * w for h, w in shapes) != s:
        raise ValueError(f"ms_deform_attn: spatial shapes {shapes} do not match {n_levels} levels of S = {s} (at most {MAX_LEVELS} levels)")
    if g is not None and (g.dtype != value.dtype or tuple(g.shape) != (n, lq, m * d)):
        raise ValueError(f"ms_deform_attn: gradient {g.dtype} {tuple(g.shape)} does not match output {value.dtype} {(n, lq, m * d)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ms_deform_attn needs contiguous tensors")


def _launch_args(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor):
    """The arguments shared by the three C functions, from shapes on."""
    n, s, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
    flat = [v for hw in shapes for v in hw]
    dev, stream = _build.device_and_stream(value)
    return ((ctypes.c_int * len(flat))(*flat), len(shapes), n, s, lq, m, d, p,
            _build.DTYPE_CODES[value.dtype], dev, stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def ms_deform_attn_fwd(value: torch.Tensor, spatial_shapes, loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: (N, Lq, M*D) in value's dtype. On CUDA
    one launch of the forward kernel (loc and aw fp32); on the CPU the plain
    version."""
    global LAUNCHES
    shapes = _static_shapes(spatial_shapes)
    if _on_cpu(value, loc, aw):
        return ms_deform_attn_plain(value, shapes, loc, aw)
    _check(value, shapes, loc, aw)
    n, _, m, d = value.shape
    out = torch.empty((n, loc.shape[1], m * d), dtype=value.dtype, device=value.device)
    rc = _fwd_fn()(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(), *_launch_args(value, shapes, loc))
    _raise_on(rc, "MSDA forward")
    LAUNCHES += 1
    return out


def ms_deform_attn_dvalue(g: torch.Tensor, value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                          aw: torch.Tensor) -> torch.Tensor:
    """dL/dvalue (N, S, M, D) in fp32 for the output gradient g (in value's
    dtype). On CUDA one launch of the dValue kernel into a zeroed fp32
    buffer; on the CPU the plain version."""
    global DVALUE_LAUNCHES
    shapes = _static_shapes(spatial_shapes)
    if _on_cpu(g, value, loc, aw):
        return ms_deform_attn_dvalue_plain(g, value, shapes, loc, aw)
    _check(value, shapes, loc, aw, g)
    dv = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    rc = _dvalue_fn()(g.data_ptr(), loc.data_ptr(), aw.data_ptr(), dv.data_ptr(), *_launch_args(value, shapes, loc))
    _raise_on(rc, "MSDA dValue")
    DVALUE_LAUNCHES += 1
    return dv


def ms_deform_attn_dlocw(g: torch.Tensor, value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                         aw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dloc (N, Lq, M, L, P, 2), dL/daw (N, Lq, M, L, P)) in fp32. On
    CUDA one launch of the dLocation/dWeight kernel; on the CPU the plain
    version."""
    global DLOCW_LAUNCHES
    shapes = _static_shapes(spatial_shapes)
    if _on_cpu(g, value, loc, aw):
        return ms_deform_attn_dlocw_plain(g, value, shapes, loc, aw)
    _check(value, shapes, loc, aw, g)
    dloc = torch.empty(loc.shape, dtype=torch.float32, device=loc.device)
    daw = torch.empty(aw.shape, dtype=torch.float32, device=aw.device)
    rc = _dlocw_fn()(g.data_ptr(), value.data_ptr(), loc.data_ptr(), aw.data_ptr(), dloc.data_ptr(),
                     daw.data_ptr(), *_launch_args(value, shapes, loc))
    _raise_on(rc, "MSDA dLocation/dWeight")
    DLOCW_LAUNCHES += 1
    return dloc, daw


# ---------------------------------------------------------------------------
# the op with its gradient, and the layer
# ---------------------------------------------------------------------------


def _upcast(t: torch.Tensor) -> torch.Tensor:
    return t.to(_acc_dtype(t.dtype)).contiguous()


class MSDeformAttnFn(torch.autograd.Function):
    """MSDA with its full gradient (the JAX op with ``pallas_backward``):
    loc and aw are upcast to fp32 at the boundary (a bf16 coordinate on a
    large level has a multi-pixel ulp); the output is in value's dtype; the
    gradients return in the caller's dtypes, dValue rounded once from fp32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, value, loc, aw, spatial_shapes):
        ctx.shapes = _static_shapes(spatial_shapes)
        value = value.contiguous()
        ctx.save_for_backward(value, loc, aw)
        return ms_deform_attn_fwd(value, ctx.shapes, _upcast(loc), _upcast(aw))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        value, loc0, aw0 = ctx.saved_tensors
        loc, aw = _upcast(loc0), _upcast(aw0)
        g = g.to(value.dtype).contiguous()
        dv = dloc = daw = None
        if ctx.needs_input_grad[0]:
            dv = ms_deform_attn_dvalue(g, value, ctx.shapes, loc, aw).to(value.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dl, da = ms_deform_attn_dlocw(g, value, ctx.shapes, loc, aw)
            dloc, daw = dl.to(loc0.dtype), da.to(aw0.dtype)
        return dv, dloc, daw, None


def ms_deform_attn(value: torch.Tensor, spatial_shapes, loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention with its gradient: (N, Lq, M*D) in
    value's dtype. On CUDA the forward is one launch of the forward kernel
    and the backward one of each backward kernel; on the CPU the plain
    versions run."""
    return MSDeformAttnFn.apply(value, loc, aw, _static_shapes(spatial_shapes))


class MSDeformAttn(nn.Module):
    """The Deformable-DETR attention layer of ``dgtd_tpu/ops/msda.py``:
    query-conditioned sampling offsets and attention weights (softmax over
    levels x points) around :func:`ms_deform_attn`.

    Four linears (``value_proj``, ``sampling_offsets``, ``attention_weights``,
    ``output_proj``) initialized as flax's default ``nn.Dense`` (lecun-normal
    weight, zero bias) from a ``torch.Generator`` seeded with ``seed`` (None
    leaves PyTorch's own init)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 seed: Optional[int] = 0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        samples = n_heads * n_levels * n_points
        self.value_proj = linear(d_model, d_model, init="lecun")
        self.sampling_offsets = linear(d_model, samples * 2, init="lecun")
        self.attention_weights = linear(d_model, samples, init="lecun")
        self.output_proj = linear(d_model, d_model, init="lecun")
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (N, Lq, C); reference_points (N, Lq, L, 2) in [0, 1], (x, y);
        value (N, S, C); spatial_shapes static ((H, W), ...)."""
        shapes = _static_shapes(spatial_shapes)
        n, lq, _ = query.shape
        m, n_levels, p = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).view(n, -1, m, self.d_model // m)
        offsets = self.sampling_offsets(query).view(n, lq, m, n_levels, p, 2)
        weights = F.softmax(self.attention_weights(query).view(n, lq, m, n_levels * p), dim=-1)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
        loc = reference_points[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        out = ms_deform_attn(v, shapes, loc, weights.view(n, lq, m, n_levels, p))
        return self.output_proj(out)
