"""The diffusion stencil on H-shards with a halo exchange (counterpart of
``dgtd_tpu/parallel/spatial.py``).

For a grid too large for one card, or to spread one image's diffusion over
several: rank i of n holds rows ``[i·H/n, (i+1)·H/n)`` of x (B, H, W, C) and
of its normalized weights (B, H, W, C, k²) (:func:`shard_rows`). Each step
takes ``r = k//2`` rows from each ring neighbour (:func:`exchange_halos`;
the edge shards get zeros, the stencil's zero padding) and runs one stencil
step on the halo'd shard with ``ops/diffusion.py::diffusion_planes``, whose
route the halo'd plane's shape picks (the fused, cluster or tiled kernel on
CUDA; the plain version on the CPU). A step moves 2·r·W·C values across
each shard boundary.

The exchange follows the group's backend: NCCL sends and receives on the
device (``batch_isend_irecv``); gloo sends host tensors, so CUDA halos go
through the host (``space.py::ring_halo``). Every stencil step runs where
x lies. :func:`spatial_planes` and :func:`spatial_nhwc` take the stencil's
own layouts (the model's ``MessagePassing`` under a data×space layout).

With a gradient to record each step is differentiable: the halo exchange's
backward returns the halo rows' gradient to their ranks
(``space.py::ring_halo``), the step's is the stencil backward on the halo'd
band (``ops/diffusion.py::DiffusionPlanesFn``: one launch of the fused,
cluster or tiled backward on CUDA), and the zero rows padded beside w take
a gradient that the pad's backward drops. A train step thus launches one
forward and one backward kernel a step on each rank's halo'd band.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.diffusion import diffusion_nhwc, diffusion_planes
from .space import ring_halo


def shard_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows (dim 1) of a full x or weight tensor; H that the
    ranks do not divide raises."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    h = x.shape[1]
    if h % n:
        raise ValueError(f"H={h} must divide evenly over {n} shards")
    return x[:, i * (h // n):(i + 1) * (h // n)]


def exchange_halos(x_local: torch.Tensor, r: int, group=None) -> torch.Tensor:
    """Pad this rank's rows (dim 1 of x_local, e.g. (B, Hs, W, C) or plane
    layout (P, Hs, W)) with r rows from each ring neighbour: the bottom rows
    of rank i−1 above, the top rows of rank i+1 below, zeros at the two
    edges. -> (.., Hs + 2r, ..)."""
    return ring_halo(x_local, r, r, group, dim=1)


def _check_shard(hs: int, r: int, kernel: int) -> None:
    if hs < r:
        raise ValueError(f"shard height {hs} < halo radius {r} (kernel {kernel}): use fewer shards or a "
                         "smaller kernel")


def spatial_planes(planes: torch.Tensor, w: torch.Tensor, kernel: int, steps: int, group=None) -> torch.Tensor:
    """``steps`` stencil steps in plane layout on this rank's rows: planes
    (P, Hs, W) and their normalized w (P, k², Hs, W). Before each step the
    halos come from the ring neighbours (:func:`exchange_halos`) and one
    ``diffusion_planes`` step runs on the halo'd (P, Hs + 2r, W) planes,
    whose route their shape picks; ``kernel = 1`` runs its steps in one
    call with no exchange. Returns this rank's rows of the result."""
    p, hs, w_ = planes.shape
    r = kernel // 2
    if r == 0:
        return diffusion_planes(planes.contiguous(), w.contiguous(), kernel, steps)
    _check_shard(hs, r, kernel)
    # w rows of zeros beside the halos: the halo rows' outputs are dropped
    wp = F.pad(w, (0, 0, r, r)).contiguous()
    out = planes.contiguous()
    for _ in range(steps):
        out = diffusion_planes(exchange_halos(out, r, group), wp, kernel, 1)[:, r:-r].contiguous()
    return out


def spatial_nhwc(x: torch.Tensor, norm_weight: torch.Tensor, kernel: int, steps: int, group=None) -> torch.Tensor:
    """The same on NHWC rows, the NHWC stencil (``diffusion_nhwc``) one
    step a call on the halo'd (B, Hs + 2r, W, C) rows: x (B, Hs, W, C),
    norm_weight (B, Hs, W, C, k²)."""
    r = kernel // 2
    if r == 0:
        return diffusion_nhwc(x.contiguous(), norm_weight, kernel, steps)
    _check_shard(x.shape[1], r, kernel)
    wp = F.pad(norm_weight, (0, 0, 0, 0, 0, 0, r, r))
    out = x.contiguous()
    for _ in range(steps):
        out = diffusion_nhwc(exchange_halos(out, r, group), wp, kernel, 1)[:, r:-r].contiguous()
    return out


def spatial_diffusion(x: torch.Tensor, norm_weight: torch.Tensor, kernel: int, steps: int,
                      group=None) -> torch.Tensor:
    """``steps`` stencil steps on this rank's H-shard, the halos exchanged
    with the neighbours before each step; every rank of ``group`` (None: the
    world group) calls it with its shard.

    x (B, Hs, W, C) and norm_weight (B, Hs, W, C, k²), already normalized,
    are this rank's rows (:func:`shard_rows`). Each shard must be at least r
    rows high, since a halo comes from the next shard only. The steps run in
    plane layout (:func:`spatial_planes`). Returns this rank's rows of the
    result."""
    b, hs, w, c = x.shape
    kk = kernel * kernel
    if tuple(norm_weight.shape) != (b, hs, w, c, kk):
        raise ValueError(f"norm_weight {tuple(norm_weight.shape)} does not match x {tuple(x.shape)} at k={kernel}")
    planes = x.permute(0, 3, 1, 2).reshape(b * c, hs, w)
    wp = norm_weight.permute(0, 3, 4, 1, 2).reshape(b * c, kk, hs, w)
    out = spatial_planes(planes, wp, kernel, steps, group)
    return out.reshape(b, c, hs, w).permute(0, 2, 3, 1).contiguous()
