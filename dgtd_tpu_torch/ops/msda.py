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
plain versions; a CUDA tensor gets the kernels or an exception. The
forward is the ``torch.library`` custom op ``dgtd_torch::msda_fwd`` (level
shapes an argument), so that ``torch.export`` traces it; the backward
kernels are called from the autograd Function.

Each kernel runs on a plan per call, :func:`msda_plan`, computed here from
the shapes and passed to the C functions, which check it: the levels a
block keeps in shared memory, the channels a lane loads at once, 32- or
64-bit offsets, and the query chunks of a head. The forward and
dLocation/dWeight kernels share one plan (value's rows staged in its
dtype); dValue has its own (``accumulate=True``: fp32 gradient rows summed
in shared memory, so a bf16 call stages no more levels than an fp32 one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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


#: the plan's arguments of the three C functions: mask, vec, wide, chunks
_PLAN_ARGS = [ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _fwd_fn():
    return _build.function("msda_fwd", "dgtd_msda_fwd", [ctypes.c_void_p] * 4 + _COMMON_ARGS + _PLAN_ARGS)


def _dvalue_fn():
    return _build.function("msda_bwd", "dgtd_msda_dvalue", [ctypes.c_void_p] * 4 + _COMMON_ARGS + _PLAN_ARGS)


def _dlocw_fn():
    return _build.function("msda_bwd", "dgtd_msda_dlocw", [ctypes.c_void_p] * 6 + _COMMON_ARGS + _PLAN_ARGS)


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
# the kernels' plan
# ---------------------------------------------------------------------------

#: threads of a forward or dLocation/dWeight block (MSDA_THREADS in the
#: CUDA sources): 32 warps, one (n, q, m) at a time each, at most 64
#: registers a thread, so one block fills an SM's registers
THREADS = 1024
#: dynamic shared memory a block may stage (MSDA_SMEM_MAX): the 227 KB a
#: Hopper block can have, less 1 KB for the level table
SMEM_MAX = 232448 - 1024
SM_COUNT = 132  # an H100 SXM; the wrappers pass the card's own count
INT32_MAX = 2 ** 31 - 1


class Plan(NamedTuple):
    """How a kernel runs one call.

    ``staged``: the levels a block keeps in shared memory (its head's rows
    of them), smallest first while they fit ``SMEM_MAX``: value's rows,
    which the forward and dLocation/dWeight kernels gather there, or
    dValue's fp32 gradient rows, which it sums there; the other levels'
    corners go through L2. ``smem_bytes``: their size.
    ``vec``: channels a lane loads at once, 16 bytes (4 fp32, 8 bf16) where
    a head row is a multiple of 16 bytes and the tensors are 16-byte
    aligned, else 1; dValue's: channels a lane adds at once into the fp32
    gradient, 4 (16 bytes; from 16 bytes of fp32 g or 8 of bf16 g) where
    D is a multiple of 4 and g and the gradient are 16-byte aligned, else
    1 (a bf16 lane of 8 channels spilled at the 64 registers a thread of a
    1024-thread block has). ``wide``: 64-bit offsets within a block, where a head's
    value or a chunk's queries reach past 2^31 elements. ``chunks``: query
    chunks per (n, m) head, a block each: with a stage, one wave of blocks
    over the card's SMs; without, one query a warp."""

    staged: Tuple[int, ...]
    smem_bytes: int
    vec: int
    wide: bool
    chunks: int


def msda_plan(shapes, n: int, lq: int, m: int, d: int, n_points: int, dtype: torch.dtype,
              aligned: bool = True, sm_count: int = SM_COUNT, accumulate: bool = False) -> Plan:
    """The plan of a call from its shapes alone (no tensor is read): the
    forward's and dLocation/dWeight's, or with ``accumulate`` dValue's,
    whose staged rows are fp32 accumulators whatever ``dtype`` (g's) is.
    ``aligned``: every tensor the kernel loads or stores with 16-byte
    accesses starts on a 16-byte boundary. Raises for more than
    ``MAX_LEVELS`` levels."""
    return _plan(_static_shapes(shapes), n, lq, m, d, n_points, dtype, aligned, sm_count, accumulate)


@functools.lru_cache(maxsize=256)
def _plan(shapes: Shapes, n: int, lq: int, m: int, d: int, n_points: int, dtype: torch.dtype,
          aligned: bool, sm_count: int, accumulate: bool) -> Plan:
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"ms_deform_attn takes 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    item = torch.empty((), dtype=dtype).element_size()
    row = d * (4 if accumulate else item)  # a staged row in shared memory
    staged, used = [], 0
    for lid in sorted(range(len(shapes)), key=lambda l: (shapes[l][0] * shapes[l][1], l)):
        size = shapes[lid][0] * shapes[lid][1] * row
        if used + size > SMEM_MAX:
            break
        staged.append(lid)
        used += size
    staged.sort()
    if accumulate:  # a lane adds 4 channels at once: 16 bytes of the fp32 gradient
        vec = 4 if aligned and d % 4 == 0 else 1
    else:
        vec = 16 // item if aligned and d * item % 16 == 0 else 1
    s = sum(h * w for h, w in shapes)
    samples = len(shapes) * n_points
    wide = max(s * m * d, lq * m * samples * 2, lq * m * d) > INT32_MAX
    most = max(1, -(-lq // (THREADS // 32)))  # a query a warp at the least
    # a block an SM: with a stage, one wave, so that each SM stages a head once
    chunks = max(1, min(most, sm_count // (n * m))) if staged else most
    return Plan(tuple(staged), used, vec, wide, chunks)


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


def aligned16(*ts: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (a slice may not)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _call_plan(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor, *loaded: torch.Tensor,
               accumulate: bool = False) -> Plan:
    """The plan for these tensors; ``loaded``: those read or written with
    16-byte accesses besides value (the output, or g), or with
    ``accumulate`` (dValue's plan, which reads no value) instead of value
    (g and dvalue)."""
    n, _, m, d = value.shape
    dev = value.device.index if value.device.index is not None else torch.cuda.current_device()
    aligned = aligned16(*loaded) if accumulate else aligned16(value, *loaded)
    return msda_plan(shapes, n, loc.shape[1], m, d, loc.shape[4], value.dtype, aligned, _sm_count(dev),
                     accumulate)


def _plan_args(plan: Plan):
    """The plan as the C functions take it: the staged levels as a bitmask."""
    return sum(1 << l for l in plan.staged), plan.vec, int(plan.wide), plan.chunks


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def ms_deform_attn_fwd(value: torch.Tensor, spatial_shapes, loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """The forward without autograd, through the ``dgtd_torch::msda_fwd``
    op: (N, Lq, M*D) in value's dtype. On CUDA one launch of the forward
    kernel on :func:`msda_plan`'s plan (loc and aw fp32); on the CPU the
    plain version. A tensor on neither, or a CUDA tensor that is not
    contiguous, raises here (the op itself takes any strides)."""
    shapes = _static_shapes(spatial_shapes)
    if not (_on_cpu(value, loc, aw) or all(t.device.type == "cuda" and t.is_contiguous() for t in (value, loc, aw))):
        _check(value, shapes, loc, aw)
    return msda_fwd_op(value, loc, aw, [v for hw in shapes for v in hw])


def _pairs(flat: Sequence[int]) -> Shapes:
    """The op's flat level shapes [H_0, W_0, H_1, W_1, ...] as pairs."""
    return tuple((int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2))


@torch.library.custom_op("dgtd_torch::msda_fwd", mutates_args=(), device_types="cuda")
def msda_fwd_op(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor, shapes: List[int]) -> torch.Tensor:
    """The MSDA forward as a ``torch.library`` op, so that ``torch.export``
    can trace it; ``shapes`` the levels' (H, W) flat. On CUDA one launch of
    the forward kernel (the plan is made here, from the shapes); a launch
    that fails raises. On the CPU the plain version. The inputs are made
    contiguous here: an exported program's strides are the trace's."""
    global LAUNCHES
    levels = _pairs(shapes)
    value, loc, aw = value.contiguous(), loc.contiguous(), aw.contiguous()
    _check(value, levels, loc, aw)
    n, _, m, d = value.shape
    out = torch.empty((n, loc.shape[1], m * d), dtype=value.dtype, device=value.device)
    plan = _call_plan(value, levels, loc, out)
    rc = _fwd_fn()(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(), *_launch_args(value, levels, loc),
                   *_plan_args(plan))
    _raise_on(rc, "MSDA forward")
    LAUNCHES += 1
    return out


@msda_fwd_op.register_kernel("cpu")
def _msda_fwd_cpu(value, loc, aw, shapes):
    return ms_deform_attn_plain(value, _pairs(shapes), loc, aw)


@msda_fwd_op.register_fake
def _msda_fwd_fake(value, loc, aw, shapes):
    n, _, m, d = value.shape
    return value.new_empty((n, loc.shape[1], m * d))


def ms_deform_attn_dvalue(g: torch.Tensor, value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                          aw: torch.Tensor) -> torch.Tensor:
    """dL/dvalue (N, S, M, D) in fp32 for the output gradient g (in value's
    dtype). On CUDA one launch of the dValue kernel on :func:`msda_plan`'s
    dValue plan into a zeroed fp32 buffer; on the CPU the plain version."""
    global DVALUE_LAUNCHES
    shapes = _static_shapes(spatial_shapes)
    if _on_cpu(g, value, loc, aw):
        return ms_deform_attn_dvalue_plain(g, value, shapes, loc, aw)
    _check(value, shapes, loc, aw, g)
    dv = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    _dvalue_launch(g, value, shapes, loc, aw, dv, _call_plan(value, shapes, loc, g, dv, accumulate=True))
    DVALUE_LAUNCHES += 1
    return dv


def _dvalue_launch(g, value, shapes: Shapes, loc, aw, dv: torch.Tensor, plan: Plan) -> None:
    """One launch of the dValue kernel on ``plan`` into the zeroed ``dv``
    (``tools/profile_msda.py`` also times it on a plan that stages
    nothing)."""
    rc = _dvalue_fn()(g.data_ptr(), loc.data_ptr(), aw.data_ptr(), dv.data_ptr(), *_launch_args(value, shapes, loc),
                      *_plan_args(plan))
    _raise_on(rc, "MSDA dValue")


def ms_deform_attn_dlocw(g: torch.Tensor, value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                         aw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dloc (N, Lq, M, L, P, 2), dL/daw (N, Lq, M, L, P)) in fp32. On
    CUDA one launch of the dLocation/dWeight kernel on :func:`msda_plan`'s
    plan; on the CPU the plain version."""
    global DLOCW_LAUNCHES
    shapes = _static_shapes(spatial_shapes)
    if _on_cpu(g, value, loc, aw):
        return ms_deform_attn_dlocw_plain(g, value, shapes, loc, aw)
    _check(value, shapes, loc, aw, g)
    dloc = torch.empty(loc.shape, dtype=torch.float32, device=loc.device)
    daw = torch.empty(aw.shape, dtype=torch.float32, device=aw.device)
    plan = _call_plan(value, shapes, loc, g)
    rc = _dlocw_fn()(g.data_ptr(), value.data_ptr(), loc.data_ptr(), aw.data_ptr(), dloc.data_ptr(),
                     daw.data_ptr(), *_launch_args(value, shapes, loc), *_plan_args(plan))
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
        from ..models.layers import init_parameters, linear

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

    def sampling(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The op's inputs: the projected value (N, S, M, D), the sampling
        locations (N, Lq, M, L, P, 2) and the attention weights
        (N, Lq, M, L, P), softmax over levels x points."""
        shapes = _static_shapes(spatial_shapes)
        n, lq, _ = query.shape
        m, n_levels, p = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).view(n, -1, m, self.d_model // m)
        offsets = self.sampling_offsets(query).view(n, lq, m, n_levels, p, 2)
        weights = F.softmax(self.attention_weights(query).view(n, lq, m, n_levels * p), dim=-1)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
        loc = reference_points[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        return v, loc, weights.view(n, lq, m, n_levels, p)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (N, Lq, C); reference_points (N, Lq, L, 2) in [0, 1], (x, y);
        value (N, S, C); spatial_shapes static ((H, W), ...)."""
        shapes = _static_shapes(spatial_shapes)
        v, loc, aw = self.sampling(query, reference_points, value, shapes)
        return self.output_proj(ms_deform_attn(v, shapes, loc, aw))
