"""Depth-diffusion stencil: the hand-written Hopper kernels
(``csrc/diffusion_stencil.cu`` forward, ``csrc/diffusion_stencil_bwd.cu``
backward) and their plain PyTorch versions.

Plane layout is the counterpart of
``dgtd_tpu/ops/diffusion_pallas.py::diffusion_pallas_v2_planes`` and its
custom VJP. The forward kernels replace the Pallas
``diffusion_step_pallas_v2``, the backward kernels both Pallas kernels of
``diffusion_step_bwd_pallas``. Four kernels each, chosen by the plane's
shape and dtype alone (``stencil_route``): a plane of at most 512 pixels at
k in {1, 3, 5, 7} (the cod recipe's 12x12 grid) runs all its steps in one
launch of the fused forward and, in backward, one of the fused backward,
the plane held in one block's shared memory; a larger plane that a thread
block cluster holds (up to 8 strips of at most 512 pixels, the paper's
grid-64 ablation among them) runs all its steps in one launch of the
cluster forward and one of the cluster backward, the strips exchanging
halo rows through distributed shared memory; every other plane at an odd
k up to 11 (grids beyond 64, the kernel9 and kernel11 ablations at any
grid) runs all its steps in one launch of the tiled forward and one of the
tiled backward, one block a tile of the plane with a halo that it
recomputes (``tiled_plan``); k >= 13, or a step count whose halo no tile
holds (``plane_route``), runs one launch of the per-step kernel a step.
Unlike the JAX package, which keeps grids under 64 on fused XLA, the port
launches kernels at every grid size on CUDA.

NHWC is the counterpart of ``diffusion_pallas`` (x (B, H, W, C), weights
(B, H, W, C, k²), tap-major inside): its forward kernels, in
``csrc/diffusion_stencil.cu``, replace the Pallas ``diffusion_step_pallas``.
The plane's shape and dtype choose them (``nhwc_route``): at an odd k up to
11 all the steps of a call run in one launch, of the NHWC plane kernel
where a block holds the whole plane and its w for one 16-byte channel group
(the recipe's 12x12), else of the NHWC grid kernel (a cooperative launch
with a grid barrier between steps); k >= 13 runs one launch of the
per-step NHWC kernel a step. Its backward moves g, the step inputs and w
into plane layout and runs the plane backward kernels (the JAX backward is
the VJP of the jnp stencil).

CPU tensors take the plain versions; a CUDA tensor gets the kernels or an
exception, never a plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

#: launches of each stencil kernel, for run-time proof of which kernels a
#: path went through; callers reset them to 0 before the run they read.
#: The fused forward and backward: one launch for all the steps of a call.
FUSED_LAUNCHES = 0
FUSED_BWD_LAUNCHES = 0
#: the cluster forward and backward (planes above the fused limit within a
#: cluster's reach): one launch for all the steps of a call
CLUSTER_LAUNCHES = 0
CLUSTER_BWD_LAUNCHES = 0
#: the tiled forward and backward (every other plane at an odd k up to
#: 11): one launch for all the steps of a call
TILED_LAUNCHES = 0
TILED_BWD_LAUNCHES = 0
#: the per-step forward and backward (k >= 13, or a step count whose halo
#: no tile holds): one launch per step
LAUNCHES = 0
BWD_LAUNCHES = 0
#: the NHWC forward: the plane and grid kernels (one launch for all the
#: steps of a call) and the per-step kernel (k >= 13: one launch a step);
#: its backward counts in the plane backward's counters
NHWC_PLANE_LAUNCHES = 0
NHWC_GRID_LAUNCHES = 0
NHWC_LAUNCHES = 0

#: the fused kernels' limit, as ``csrc/stencil_common.cuh::fused_fits``
#: states it: one thread per pixel with k a template argument, so a pixel's
#: k² weights (forward) or dw sums (backward) are registers; 512 threads
#: leave a thread 128 registers. Shared memory (the backward's three padded
#: fp32 planes and its k² weight planes) must fit a block's 227 KB; within
#: the pixel limit it is at most 144 KB, so the pixel count binds first.
FUSED_KERNELS = (1, 3, 5, 7)
FUSED_MAX_PIXELS = 512
FUSED_SMEM_LIMIT = 232448


#: the cluster kernels' limit, as ``csrc/stencil_common.cuh::stencil_route``
#: states it: the plane in strips of at most FUSED_MAX_PIXELS pixels, one
#: block a strip, at most 8 blocks (the portable cluster size); a strip of
#: at least r rows, so that a halo row comes from the adjacent strip only;
#: the backward's shared memory (four padded fp32 strips and the k² weight
#: planes of the strip and its halo rows) within a block's 227 KB.
CLUSTER_MAX_BLOCKS = 8


def fused_path(h: int, w: int, kernel: int, dtype: torch.dtype) -> bool:
    """Whether an (H, W) plane at this kernel and dtype takes the fused
    kernels (all steps in one launch, one block a plane)."""
    r = kernel // 2
    smem = 3 * 4 * (h + 2 * r) * (w + 2 * r) + kernel * kernel * h * w * dtype.itemsize
    return kernel in FUSED_KERNELS and 0 < h * w <= FUSED_MAX_PIXELS and smem <= FUSED_SMEM_LIMIT


def cluster_split(h: int, w: int) -> Tuple[int, int]:
    """(blocks, rows): the cluster kernels' split of an (H, W) plane into
    strips of ``rows`` rows (the last may be shorter), as few blocks as hold
    it at most FUSED_MAX_PIXELS pixels a strip, the strips as even as that
    allows; (0, 0) if one row is wider than a block."""
    most = FUSED_MAX_PIXELS // w if w > 0 else 0
    if h <= 0 or most == 0:
        return 0, 0
    blocks = -(-h // most)
    return blocks, -(-h // blocks)


def stencil_route(h: int, w: int, kernel: int, dtype: torch.dtype) -> str:
    """Which kernels run an (H, W) plane at this kernel and dtype on CUDA:
    "fused", "cluster", "tiled" (every other plane at an odd k up to
    TILED_MAX_KERNEL) or "per_step" (k >= 13)."""
    if fused_path(h, w, kernel, dtype):
        return "fused"
    blocks, rows = cluster_split(h, w)
    r = kernel // 2
    smem = 4 * 4 * (rows + 2 * r) * (w + 2 * r) + (kernel * kernel * (rows + 2 * r) * w + 2 * r) * dtype.itemsize
    if kernel in FUSED_KERNELS and 0 < blocks <= CLUSTER_MAX_BLOCKS and rows >= r and smem <= FUSED_SMEM_LIMIT:
        return "cluster"
    if kernel % 2 == 1 and 1 <= kernel <= TILED_MAX_KERNEL and h > 0 and w > 0:
        return "tiled"
    return "per_step"


#: the tiled kernels' limits, as ``csrc/stencil_common.cuh`` states them:
#: k a template argument up to 11 (the kernel3..kernel11 ablations); tiles
#: of at most 256 rows; the backward's w-in-shared-memory mode at 2 or more
#: steps while its tiles read at most 3/2 times the plane's w
TILED_MAX_KERNEL = 11
TILED_MAX_TILE_ROWS = 256
TILED_WS_MAX_RATIO = 1.5
#: without ws mode, tiles of at most 2048 pixels (a 96 x 96 plane 5 tiles)
#: and 115712 bytes of shared memory (two blocks an SM)
TILED_STREAM_MAX_PIXELS = 2048
TILED_STREAM_SMEM = 233472 // 2 - 1024


def _tiled_w_halo(kernel: int, steps: int, bwd: bool) -> int:
    return (kernel // 2) * (steps if bwd else steps - 1)


def tiled_smem(th: int, tw: int, h: int, w: int, kernel: int, steps: int, elem_bytes: int, bwd: bool,
               ws: bool) -> int:
    """Shared memory of a tiled block of th x tw interior pixels: two fp32
    buffers of the interior grown by steps·r (within r of the plane); in
    backward every step's gradient on the interior and input on the
    interior grown by r, and in ws mode the k² weight planes on the region
    the steps read them (grown by steps·r, within the plane)."""
    r, halo = kernel // 2, steps * (kernel // 2)
    nbytes = 8 * min(th + 2 * halo, h + 2 * r) * min(tw + 2 * halo, w + 2 * r)
    if bwd:
        nbytes += 4 * steps * (th * tw + (th + 2 * r) * (tw + 2 * r))
    if ws:
        wh = _tiled_w_halo(kernel, steps, bwd)
        nbytes += kernel * kernel * min(th + 2 * wh, h) * min(tw + 2 * wh, w) * elem_bytes
    return nbytes


def _tiled_search(h, w, kernel, steps, elem_bytes, bwd, ws, budget):
    """(plan, cost): the tile within ``budget`` bytes that reads the fewest
    w values in all (tiles x its w region), fewer tiles on a tie, rows and
    columns split as evenly as their counts allow (without ws, at most
    TILED_STREAM_MAX_PIXELS pixels a tile); plan None if none fits."""
    best, best_cost, best_tiles = None, -1, 0
    wh = _tiled_w_halo(kernel, steps, bwd)
    for th0 in range(1, min(h, TILED_MAX_TILE_ROWS) + 1):
        ny = -(-h // th0)
        th = -(-h // ny)
        if tiled_smem(th, 1, h, w, kernel, steps, elem_bytes, bwd, ws) > budget:
            break
        lo, hi = 1, w if ws else min(w, TILED_STREAM_MAX_PIXELS // th)
        while lo < hi:
            mid = lo + (hi - lo + 1) // 2
            if tiled_smem(th, mid, h, w, kernel, steps, elem_bytes, bwd, ws) <= budget:
                lo = mid
            else:
                hi = mid - 1
        nx = -(-w // lo)
        tw = -(-w // nx)
        tiles = ny * nx
        cost = tiles * min(th + 2 * wh, h) * min(tw + 2 * wh, w)
        if best is None or cost < best_cost or (cost == best_cost and tiles < best_tiles):
            best, best_cost, best_tiles = (th, tw, ws), cost, tiles
    return best, best_cost


@functools.lru_cache(maxsize=4096)
def tiled_plan(h: int, w: int, kernel: int, steps: int, dtype: torch.dtype,
               bwd: bool = False) -> Optional[Tuple[int, int, bool]]:
    """(tile rows, tile columns, ws mode) of the tiled forward (or backward)
    on an (H, W) plane, as ``csrc/stencil_common.cuh::tiled_plan`` decides
    it; None if no tile fits. In backward at 2 or more steps ws mode (w
    staged in shared memory by the first step) where its tiles read at most
    TILED_WS_MAX_RATIO times the plane's w; else w from memory every step in
    a tile of at most TILED_STREAM_SMEM bytes (two blocks an SM) or, failing
    that, a block's whole shared memory."""
    if h < 1 or w < 1 or steps < 1 or kernel % 2 == 0 or not 1 <= kernel <= TILED_MAX_KERNEL:
        return None
    eb = dtype.itemsize
    if bwd and steps > 1:
        plan, cost = _tiled_search(h, w, kernel, steps, eb, bwd, True, FUSED_SMEM_LIMIT)
        if plan is not None and cost <= TILED_WS_MAX_RATIO * h * w:
            return plan
    plan, _ = _tiled_search(h, w, kernel, steps, eb, bwd, False, TILED_STREAM_SMEM)
    if plan is None:
        plan, _ = _tiled_search(h, w, kernel, steps, eb, bwd, False, FUSED_SMEM_LIMIT)
    return plan


def nhwc_plane_smem(h: int, w: int, kernel: int, dtype: torch.dtype) -> int:
    """Shared memory of an NHWC plane-kernel block: the whole (H, W) plane
    padded by r as two fp32 buffers and the plane's k² weight planes, for
    one 16-byte channel group (4 fp32, 8 bf16 channels): a tiled plane tile
    in ws mode (``tiled_smem``) times the group's channels."""
    return tiled_smem(h, w, h, w, kernel, 1, dtype.itemsize, False, True) * (16 // dtype.itemsize)


@functools.lru_cache(maxsize=4096)
def nhwc_route(h: int, w: int, kernel: int, dtype: torch.dtype) -> str:
    """Which kernel runs the steps of a call on (H, W) NHWC planes on CUDA,
    as ``csrc/diffusion_stencil.cu::nhwc_route`` decides it from shape and
    dtype alone (not B, C or the step count): "plane" (a block holds the
    plane and its w, all the steps in one launch) where its shared memory
    fits a block, "grid" (all the steps in one cooperative launch) at every
    other odd k up to TILED_MAX_KERNEL, else "per_step"."""
    if h < 1 or w < 1 or kernel % 2 == 0 or not 1 <= kernel <= TILED_MAX_KERNEL:
        return "per_step"
    return "plane" if nhwc_plane_smem(h, w, kernel, dtype) <= FUSED_SMEM_LIMIT else "grid"


def plane_route(h: int, w: int, kernel: int, dtype: torch.dtype, steps: int) -> str:
    """The route a call of ``steps`` steps takes: ``stencil_route``, but
    "per_step" for a tiled plane whose halo at this step count no tile
    holds (k = 11 beyond 16 steps on a plane that one tile does not hold,
    for one)."""
    route = stencil_route(h, w, kernel, dtype)
    if route == "tiled" and (tiled_plan(h, w, kernel, steps, dtype) is None
                             or tiled_plan(h, w, kernel, steps, dtype, True) is None):
        return "per_step"
    return route


#: the C entries of the all-steps kernels (forward, backward) by route;
#: they take the same arguments
_ALL_STEPS = {"fused": ("dgtd_diffusion_fused", "dgtd_diffusion_fused_bwd"),
              "cluster": ("dgtd_diffusion_cluster", "dgtd_diffusion_cluster_bwd"),
              "tiled": ("dgtd_diffusion_tiled", "dgtd_diffusion_tiled_bwd")}
_ALL_STEPS_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_ALL_STEPS_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


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


def _nhwc_plane_fn():
    return _build.function("diffusion_stencil", "dgtd_diffusion_nhwc_plane", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


_ROUTES = ("fused", "cluster", "per_step", "tiled")


def native_route(h: int, w: int, kernel: int, dtype: torch.dtype) -> Tuple[str, Tuple[int, int]]:
    """The route and the cluster split (blocks, rows) of an (H, W) plane as
    the C entries decide them (``csrc/stencil_common.cuh``), for holding
    ``stencil_route`` and ``cluster_split`` to them. Builds the library."""
    fn = _build.function("diffusion_stencil", "dgtd_stencil_route", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ])
    blocks, rows = ctypes.c_int(), ctypes.c_int()
    route = fn(h, w, kernel, dtype.itemsize, ctypes.byref(blocks), ctypes.byref(rows))
    return _ROUTES[route], (blocks.value, rows.value)


def native_tiled_plan(h: int, w: int, kernel: int, steps: int, dtype: torch.dtype,
                      bwd: bool = False) -> Tuple[Optional[Tuple[int, int, bool]], int]:
    """The tiled plan and its shared memory in bytes as the C entries decide
    them, for holding ``tiled_plan`` and ``tiled_smem`` to them. Builds the
    library."""
    fn = _build.function("diffusion_stencil", "dgtd_tiled_plan", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ], restype=ctypes.c_longlong)
    th, tw, ws = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = fn(h, w, kernel, steps, dtype.itemsize, int(bwd), ctypes.byref(th), ctypes.byref(tw), ctypes.byref(ws))
    return ((th.value, tw.value, bool(ws.value)) if th.value else None), smem


def native_nhwc_route(h: int, w: int, kernel: int, dtype: torch.dtype) -> Tuple[str, int]:
    """The NHWC route and the plane kernel's shared memory in bytes as the C
    entries decide them, for holding ``nhwc_route`` and ``nhwc_plane_smem``
    to them. Builds the library."""
    fn = _build.function("diffusion_stencil", "dgtd_nhwc_route", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
    ])
    smem = ctypes.c_longlong()
    route = fn(h, w, kernel, dtype.itemsize, ctypes.byref(smem))
    return ("plane", "grid", "per_step")[route], smem.value


def cluster_occupancy(blocks: int, rows: int, w: int, backward: bool, device: int = 0) -> int:
    """How many clusters of ``blocks`` blocks of ``rows`` x ``w`` pixels the
    k = 7 bf16 cluster forward (or backward) keeps on the card at once
    (``cudaOccupancyMaxActiveClusters``; sizes above the portable 8 are
    allowed for the query). Builds the library."""
    name, symbol = (("diffusion_stencil_bwd", "dgtd_diffusion_cluster_bwd_occupancy") if backward
                    else ("diffusion_stencil", "dgtd_diffusion_cluster_occupancy"))
    fn = _build.function(name, symbol, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)])
    clusters = ctypes.c_int()
    rc = fn(blocks, rows, w, device, ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"cluster occupancy query failed: cudaError {rc}")
    return clusters.value


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


def _forward_steps(
    x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int, keep: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the steps; returns (output, xs): xs holds every step's input as
    one (steps, P, H, W) tensor when ``keep`` (saved for backward), else it
    is None. The output is never x itself (a Function's output must not be
    its input): 0 steps return a copy."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        if steps == 0:
            return x.clone(), x.new_empty((0, *x.shape)) if keep else None
        outs = [x]
        for _ in range(steps):
            outs.append(diffusion_step_plain(outs[-1], w, kernel))
        return outs[-1], torch.stack(outs[:-1]) if keep else None
    _check(x, w, kernel, steps)
    xs = torch.empty((steps, *x.shape), dtype=x.dtype, device=x.device) if keep else None
    if steps == 0:
        return x.clone(), xs
    out = torch.empty_like(x)
    route = plane_route(x.shape[1], x.shape[2], kernel, x.dtype, steps)
    if route == "fused":
        _fused_forward(x, w, kernel, steps, xs, out)
    elif route == "cluster":
        _cluster_forward(x, w, kernel, steps, xs, out)
    elif route == "tiled":
        _tiled_forward(x, w, kernel, steps, xs, out)
    else:
        _per_step_forward(x, w, kernel, steps, xs, out)
    return out, xs


def _all_steps_forward(route: str, x, w, kernel: int, steps: int, xs: Optional[torch.Tensor],
                       out: torch.Tensor) -> None:
    """All ``steps`` steps in one launch of the route's forward kernel
    ("fused", "cluster" or "tiled") into ``out``, every step's input into ``xs``
    unless it is None. A launch that fails raises: nothing falls back."""
    p, h, wd = x.shape
    dev, stream = _build.device_and_stream(x)
    fn = _build.function("diffusion_stencil", _ALL_STEPS[route][0], _ALL_STEPS_FWD_ARGS)
    rc = fn(x.data_ptr(), w.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
            p, h, wd, kernel, steps, _build.DTYPE_CODES[x.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"{route} diffusion stencil launch failed: cudaError {rc}")


def _fused_forward(x, w, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    global FUSED_LAUNCHES
    _all_steps_forward("fused", x, w, kernel, steps, xs, out)
    FUSED_LAUNCHES += 1


def _cluster_forward(x, w, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    global CLUSTER_LAUNCHES
    _all_steps_forward("cluster", x, w, kernel, steps, xs, out)
    CLUSTER_LAUNCHES += 1


def _tiled_forward(x, w, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    global TILED_LAUNCHES
    _all_steps_forward("tiled", x, w, kernel, steps, xs, out)
    TILED_LAUNCHES += 1


def _per_step_forward(x, w, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """One launch of the per-step forward kernel a step: the steps' inputs
    into ``xs`` or, when it is None, into two ping-pong buffers; the last
    step into ``out``."""
    global LAUNCHES
    fn = _fwd_fn()
    p, h, wd = x.shape
    code = _build.DTYPE_CODES[x.dtype]
    dev, stream = _build.device_and_stream(x)
    if xs is not None:
        xs[0].copy_(x)
    bufs = [torch.empty_like(x) for _ in range(min(steps - 1, 2))] if xs is None else None
    src = x
    for s in range(steps):
        dst = out if s == steps - 1 else (bufs[s % 2] if xs is None else xs[s + 1])
        rc = fn(src.data_ptr(), w.data_ptr(), dst.data_ptr(), p, h, wd, kernel, code, dev, stream)
        if rc != 0:
            raise RuntimeError(f"diffusion stencil launch failed: cudaError {rc}")
        LAUNCHES += 1
        src = dst


def diffusion_planes_bwd(
    g: torch.Tensor, xs: Union[torch.Tensor, Sequence[torch.Tensor]], w: torch.Tensor, kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``len(xs)`` steps whose inputs were ``xs`` (a sequence of
    (P, H, W) tensors or one (steps, P, H, W) tensor): (dx, dw). On CUDA one
    launch of the fused, the cluster or the tiled backward for all the
    steps, as ``plane_route`` says, else one launch of the per-step backward
    a step;
    dw is summed in fp32 and cast to w's dtype once. On the CPU the plain
    version."""
    if g.device.type == "cpu" and w.device.type == "cpu":
        return diffusion_planes_bwd_plain(g, xs, w, kernel)
    steps = len(xs)
    _check(g, w, kernel, steps)
    if not torch.is_tensor(xs):
        xs = torch.stack(list(xs)) if steps else g.new_empty((0, *g.shape))
    if xs.device != g.device or xs.dtype != g.dtype or tuple(xs.shape) != (steps, *g.shape):
        raise ValueError("diffusion_planes_bwd needs step inputs like g: one device, dtype and shape")
    if steps == 0:
        return g, torch.zeros_like(w)
    xs = xs.contiguous()
    route = plane_route(g.shape[1], g.shape[2], kernel, g.dtype, steps)
    if route == "fused":
        return _fused_backward(g, xs, w, kernel)
    if route == "cluster":
        return _cluster_backward(g, xs, w, kernel)
    if route == "tiled":
        return _tiled_backward(g, xs, w, kernel)
    return _per_step_backward(g, xs, w, kernel)


def _all_steps_backward(route: str, g, xs: torch.Tensor, w, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of all ``len(xs)`` steps in one launch of the route's
    backward kernel ("fused", "cluster" or "tiled"); dw summed on chip and written
    once, in w's dtype. A launch that fails raises."""
    p, h, wd = g.shape
    dev, stream = _build.device_and_stream(g)
    dx, dw = torch.empty_like(g), torch.empty_like(w)
    fn = _build.function("diffusion_stencil_bwd", _ALL_STEPS[route][1], _ALL_STEPS_BWD_ARGS)
    rc = fn(g.data_ptr(), xs.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            p, h, wd, kernel, len(xs), _build.DTYPE_CODES[g.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"{route} diffusion stencil backward launch failed: cudaError {rc}")
    return dx, dw


def _fused_backward(g, xs: torch.Tensor, w, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global FUSED_BWD_LAUNCHES
    out = _all_steps_backward("fused", g, xs, w, kernel)
    FUSED_BWD_LAUNCHES += 1
    return out


def _cluster_backward(g, xs: torch.Tensor, w, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global CLUSTER_BWD_LAUNCHES
    out = _all_steps_backward("cluster", g, xs, w, kernel)
    CLUSTER_BWD_LAUNCHES += 1
    return out


def _tiled_backward(g, xs: torch.Tensor, w, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global TILED_BWD_LAUNCHES
    out = _all_steps_backward("tiled", g, xs, w, kernel)
    TILED_BWD_LAUNCHES += 1
    return out


def _per_step_backward(g, xs: torch.Tensor, w, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the per-step backward kernel a step, in reverse; dw
    summed in fp32 and cast to w's dtype by the last launch."""
    global BWD_LAUNCHES
    fn = _bwd_fn()
    p, h, wd = g.shape
    code = _build.DTYPE_CODES[g.dtype]
    dev, stream = _build.device_and_stream(g)
    dw_out = torch.empty_like(w)
    # fp32 weights sum dw in place in the output; bf16 weights in an fp32
    # buffer that the last step reads once and rounds into the output
    dw_acc = dw_out if w.dtype == torch.float32 else torch.empty(w.shape, dtype=torch.float32, device=w.device)
    dw_in = None
    for s in range(len(xs) - 1, -1, -1):
        dst = dw_out if s == 0 else dw_acc
        dx = torch.empty_like(g)
        rc = fn(g.data_ptr(), xs[s].data_ptr(), w.data_ptr(), dx.data_ptr(),
                None if dw_in is None else dw_in.data_ptr(), dst.data_ptr(),
                p, h, wd, kernel, code, _build.DTYPE_CODES[dst.dtype], dev, stream)
        if rc != 0:
            raise RuntimeError(f"diffusion stencil backward launch failed: cudaError {rc}")
        BWD_LAUNCHES += 1
        g, dw_in = dx, dw_acc
    return g, dw_out


class DiffusionPlanesFn(torch.autograd.Function):
    """``steps`` stencil steps with their backward: forward saves w and every
    step's input (one (steps, P, H, W) tensor), backward runs the steps in
    reverse. The custom_fwd/custom_bwd pair makes backward see forward's
    autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, kernel, steps):
        keep = any(ctx.needs_input_grad[:2])
        out, xs = _forward_steps(x, w, kernel, steps, keep)
        ctx.kernel = kernel
        if keep:
            ctx.save_for_backward(w, xs)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        w, xs = ctx.saved_tensors
        dx, dw = diffusion_planes_bwd(g.contiguous(), xs, w, ctx.kernel)
        return dx, dw, None, None


def diffusion_planes(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` affinity-weighted stencil steps in plane layout, with their
    gradient.

    x (P, H, W) and w (P, k², H, W), w already normalized, P = B·C. On CUDA
    a plane that ``plane_route`` sends to the fused, the cluster or the
    tiled kernels takes one launch of that forward for all the steps and, in
    backward, one of that backward; the per-step route one launch of the
    per-step kernels a step. On the CPU the plain
    versions run. Without a gradient to record (serving) the forward runs
    without the autograd Function, whose ``apply`` costs more host time than
    the fused launch itself."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DiffusionPlanesFn.apply(x, w, kernel, steps)
    return _forward_steps(x, w, kernel, steps, keep=False)[0]


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


def _nhwc_forward_steps(x: torch.Tensor, w_tm: torch.Tensor, kernel: int, steps: int,
                        keep: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the steps; returns (output, xs): xs holds every step's input as
    one (steps, B, H, W, C) tensor when ``keep`` (saved for backward), else
    it is None. The output is never x itself: 0 steps return a copy."""
    if x.device.type == "cpu" and w_tm.device.type == "cpu":
        if steps == 0:
            return x.clone(), x.new_empty((0, *x.shape)) if keep else None
        outs = [x]
        for _ in range(steps):
            outs.append(diffusion_step_nhwc_plain(outs[-1], w_tm, kernel))
        return outs[-1], torch.stack(outs[:-1]) if keep else None
    _check_nhwc(x, w_tm, kernel, steps)
    xs = torch.empty((steps, *x.shape), dtype=x.dtype, device=x.device) if keep else None
    if steps == 0:
        return x.clone(), xs
    out = torch.empty_like(x)
    route = nhwc_route(x.shape[1], x.shape[2], kernel, x.dtype)
    if route == "plane":
        _nhwc_plane_forward(x, w_tm, kernel, steps, xs, out)
    elif route == "grid":
        _nhwc_grid_forward(x, w_tm, kernel, steps, xs, out)
    else:
        _nhwc_per_step_forward(x, w_tm, kernel, steps, xs, out)
    return out, xs


def _nhwc_plane_forward(x, w_tm, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """All ``steps`` steps in one launch of the NHWC plane kernel into
    ``out``, every step's input into ``xs`` unless it is None. A launch that
    fails raises: nothing falls back."""
    global NHWC_PLANE_LAUNCHES
    b, h, wd, c = x.shape
    dev, stream = _build.device_and_stream(x)
    rc = _nhwc_plane_fn()(x.data_ptr(), w_tm.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
                          b, h, wd, c, kernel, steps, _build.DTYPE_CODES[x.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"NHWC plane diffusion stencil launch failed: cudaError {rc}")
    NHWC_PLANE_LAUNCHES += 1


def _nhwc_grid_fn():
    return _build.function("diffusion_stencil", "dgtd_diffusion_nhwc_grid", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])


def _nhwc_grid_forward(x, w_tm, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """All ``steps`` steps in one cooperative launch of the NHWC grid kernel
    into ``out``, every step's input into ``xs`` unless it is None (then
    the steps between go through scratch tensors like x)."""
    global NHWC_GRID_LAUNCHES
    b, h, wd, c = x.shape
    dev, stream = _build.device_and_stream(x)
    scratch = None if xs is not None or steps < 2 else torch.empty((min(steps - 1, 2), *x.shape), dtype=x.dtype,
                                                                      device=x.device)
    count = torch.empty(1, dtype=torch.int32, device=x.device)
    rc = _nhwc_grid_fn()(x.data_ptr(), w_tm.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(), count.data_ptr(), b, h, wd, c, kernel, steps,
                         _build.DTYPE_CODES[x.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"NHWC grid diffusion stencil launch failed: cudaError {rc}")
    NHWC_GRID_LAUNCHES += 1


def _nhwc_per_step_forward(x, w_tm, kernel: int, steps: int, xs: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """One launch of the per-step NHWC kernel a step: the steps' inputs into
    ``xs`` or, when it is None, into two ping-pong buffers; the last step
    into ``out``."""
    global NHWC_LAUNCHES
    fn = _nhwc_fn()
    b, h, wd, c = x.shape
    code = _build.DTYPE_CODES[x.dtype]
    dev, stream = _build.device_and_stream(x)
    if xs is not None:
        xs[0].copy_(x)
    bufs = [torch.empty_like(x) for _ in range(min(steps - 1, 2))] if xs is None else None
    src = x
    for s in range(steps):
        dst = out if s == steps - 1 else (bufs[s % 2] if xs is None else xs[s + 1])
        rc = fn(src.data_ptr(), w_tm.data_ptr(), dst.data_ptr(), b, h, wd, c, kernel, code, dev, stream)
        if rc != 0:
            raise RuntimeError(f"NHWC diffusion stencil launch failed: cudaError {rc}")
        NHWC_LAUNCHES += 1
        src = dst


def _nhwc_to_planes(t: torch.Tensor) -> torch.Tensor:
    """(..., B, H, W, C) -> (..., B·C, H, W)."""
    *lead, b, h, w, c = t.shape
    return t.movedim(-1, -3).reshape(*lead, b * c, h, w)


class DiffusionNHWCFn(torch.autograd.Function):
    """``steps`` NHWC stencil steps on tap-major weights with their
    backward: forward saves w and every step's input (one
    (steps, B, H, W, C) tensor); backward runs the plane backward (its
    kernels on CUDA, chosen by ``plane_route``; plain on the CPU) on g, the
    step inputs and w moved into plane layout; dw returns tap-major."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w_tm, kernel, steps):
        keep = any(ctx.needs_input_grad[:2])
        out, xs = _nhwc_forward_steps(x, w_tm, kernel, steps, keep)
        ctx.kernel = kernel
        if keep:
            ctx.save_for_backward(w_tm, xs)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        w_tm, xs = ctx.saved_tensors
        b, h, w, c = g.shape
        k = ctx.kernel
        kk = k * k
        wp = w_tm.view(b, h, w, kk, c).permute(0, 4, 3, 1, 2).reshape(b * c, kk, h, w)
        dxp, dwp = diffusion_planes_bwd(_nhwc_to_planes(g.contiguous()), _nhwc_to_planes(xs), wp, k)
        dx = dxp.view(b, c, h, w).permute(0, 2, 3, 1).contiguous()
        dw = dwp.view(b, c, kk, h, w).permute(0, 3, 4, 2, 1).reshape(b, h, w, kk * c)
        return dx, dw, None, None


def diffusion_nhwc_tap_major(x: torch.Tensor, w_tm: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` NHWC stencil steps on tap-major weights (B, H, W, k²·C),
    with their gradient. On CUDA the steps of a call are one launch of the
    NHWC plane or grid kernel, as ``nhwc_route`` says, else (k >= 13) one
    launch of the per-step NHWC kernel a step; the backward is the plane backward's
    (one fused, cluster or tiled launch where ``plane_route`` says so). On
    the CPU the plain versions run. Without a gradient to record the
    forward runs without the autograd Function and writes no step inputs."""
    if torch.is_grad_enabled() and (x.requires_grad or w_tm.requires_grad):
        return DiffusionNHWCFn.apply(x, w_tm, kernel, steps)
    return _nhwc_forward_steps(x, w_tm, kernel, steps, keep=False)[0]


def diffusion_nhwc(x: torch.Tensor, norm_weight: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``steps`` iterations of the normalized-affinity stencil in NHWC, the
    counterpart of ``dgtd_tpu``'s ``diffusion_pallas``: x (B, H, W, C),
    norm_weight (B, H, W, C, k²) normalized; the weights go tap-major once
    and the gradient returns to norm_weight's layout."""
    return diffusion_nhwc_tap_major(x, to_tap_major(norm_weight), kernel, steps)
