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
through the host. Every stencil step runs where x lies. This is the
serving path: it records no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.diffusion import diffusion_planes


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


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
    n, i = dist.get_world_size(group), dist.get_rank(group)
    top, bottom = x_local[:, :r].contiguous(), x_local[:, -r:].contiguous()
    from_prev, from_next = torch.zeros_like(top), torch.zeros_like(bottom)
    host = dist.get_backend(group) != "nccl" and x_local.device.type != "cpu"
    sends, recvs = [], []
    if i > 0:
        sends.append((top, _peer(group, i - 1)))
        recvs.append((from_prev, _peer(group, i - 1)))
    if i < n - 1:
        sends.append((bottom, _peer(group, i + 1)))
        recvs.append((from_next, _peer(group, i + 1)))
    if host:
        # gloo's send and recv take CPU tensors
        sends = [(t.cpu(), p) for t, p in sends]
        landed = [(torch.empty(t.shape, dtype=t.dtype), p) for t, p in recvs]
    else:
        landed = recvs
    if dist.get_backend(group) == "nccl":
        ops = [dist.P2POp(dist.isend, t, p, group) for t, p in sends]
        works = dist.batch_isend_irecv(ops + [dist.P2POp(dist.irecv, t, p, group) for t, p in landed]) if ops else []
    else:
        works = [dist.isend(t, p, group=group) for t, p in sends] + [dist.irecv(t, p, group=group) for t, p in landed]
    for work in works:
        work.wait()
    if host:
        for (dst, _), (src, _) in zip(recvs, landed):
            dst.copy_(src)
    return torch.cat([from_prev, x_local, from_next], dim=1)


@torch.no_grad()
def spatial_diffusion(x: torch.Tensor, norm_weight: torch.Tensor, kernel: int, steps: int,
                      group=None) -> torch.Tensor:
    """``steps`` stencil steps on this rank's H-shard, the halos exchanged
    with the neighbours before each step; every rank of ``group`` (None: the
    world group) calls it with its shard.

    x (B, Hs, W, C) and norm_weight (B, Hs, W, C, k²), already normalized,
    are this rank's rows (:func:`shard_rows`). Each shard must be at least r
    rows high, since a halo comes from the next shard only. ``kernel = 1``
    is pointwise: its steps run in one call on the shard, with no exchange.
    Returns this rank's rows of the result."""
    b, hs, w, c = x.shape
    kk = kernel * kernel
    if tuple(norm_weight.shape) != (b, hs, w, c, kk):
        raise ValueError(f"norm_weight {tuple(norm_weight.shape)} does not match x {tuple(x.shape)} at k={kernel}")
    r = kernel // 2
    planes = x.permute(0, 3, 1, 2).reshape(b * c, hs, w).contiguous()
    wp = norm_weight.permute(0, 3, 4, 1, 2).reshape(b * c, kk, hs, w)
    if r == 0:
        out = diffusion_planes(planes, wp.contiguous(), kernel, steps)
    else:
        if hs < r:
            raise ValueError(f"shard height {hs} < halo radius {r} (kernel {kernel}): use fewer shards or a "
                             "smaller kernel")
        # w rows of zeros beside the halos: the halo rows' outputs are dropped
        wp = F.pad(wp, (0, 0, r, r)).contiguous()
        out = planes
        for _ in range(steps):
            out = diffusion_planes(exchange_halos(out, r, group), wp, kernel, 1)[:, r:-r].contiguous()
    return out.reshape(b, c, hs, w).permute(0, 2, 3, 1).contiguous()
