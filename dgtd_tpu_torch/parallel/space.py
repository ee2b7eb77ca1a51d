"""The 2-D data×space layout of a served forward (counterpart of the 2-D half
of ``dgtd_tpu/parallel/mesh.py``: ``make_mesh(data, space)``,
``batch_sharding``'s ``P('data', 'space')``, ``active_mesh`` and
``spatial_constraint``).

The JAX package lets XLA partition every activation of ``model.predict``
over a mesh of ``data × space`` devices: the batch over ``data``, H over
``space``. Here each rank is a process. Global rank ``d·space + s`` holds
rows ``[i·B/data, (i+1)·B/data)`` of the batch for ``d = i`` and, of every
activation whose level is *banded*, its band of H: rows
``[s·H/space, (s+1)·H/space)``. W is never split.

The layout rule is ``spatial_constraint``'s: a level of global height H is
banded when ``space`` divides H, otherwise every rank of the space group
holds it whole (*replicated*). A layer that runs on a band needs two more
things: a strided conv's band must start on a multiple of its stride, and
its halo must not be taller than a band. Where the rule or the geometry
says no, the layer gathers its input, computes the whole level on every
rank and bands the result again where the next level is banded
(:func:`conv_rows`). Each choice is counted (:data:`COUNT_KEYS`), per
forward when the caller resets the counts.

Model code reads the layout from :func:`active_space`'s context. With no
active space every function here is an exact no-op, so one process runs
the same code as before. Sizes passed here are always global, never a
band's. This is the serving layout: a banded primitive that sees a tensor
requiring grad raises (the train step under it is ROADMAP A13c).

Collectives follow the group's backend as in ``parallel/spatial.py``: NCCL
gathers with ``all_gather_into_tensor`` and exchanges halos with
``batch_isend_irecv`` on the device; gloo takes host tensors, so CUDA
tensors go through the host.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

#: what a forward counts: layers with a spatial extent (convs wider or
#: more strided than 1x1, attention, the stencil, band-local resizes) run
#: on a band or on a replicated level; ops computed on a gathered whole
#: level (resizes, the FFT); all-gathers of rows or batches and their
#: bytes; halo exchanges and the bytes received; all-reduces of spatial
#: means and extrema
COUNT_KEYS = ("banded", "replicated", "full", "gathers", "gather_bytes", "halos", "halo_bytes", "reductions")


@dataclass
class Space:
    """One rank's place in the layout: ``data`` rows × ``space`` columns of
    ranks, this rank at (``data_index``, ``space_index``); its space group
    (the ranks of its data row) and data group (the ranks of its space
    column); the counts of :data:`COUNT_KEYS`."""

    data: int
    space: int
    data_index: int
    space_index: int
    space_group: object
    data_group: object
    counts: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(COUNT_KEYS, 0))

    def reset_counts(self) -> None:
        self.counts.update(dict.fromkeys(COUNT_KEYS, 0))


def make_space(data: int, space: int) -> Space:
    """This rank's place in a ``data × space`` layout of the started process
    group, whose size must be ``data·space``. Global rank ``d·space + s``
    is (d, s), as ``make_mesh`` reshapes the devices to (data, space).
    Every rank calls it, in the same order: it makes every subgroup (each
    data row's space group, then each column's data group) on every rank,
    as ``new_group`` requires."""
    data, space = int(data), int(space)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or space < 1 or data * space != world:
        raise ValueError(f"a {data}×{space} layout needs {data * space} ranks, the process group has {world}")
    space_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * space + s for s in range(space)])
        if rank // space == d:
            space_group = g
    for s in range(space):
        g = dist.new_group([d * space + s for d in range(data)])
        if rank % space == s:
            data_group = g
    return Space(data, space, rank // space, rank % space, space_group, data_group)


#: the layout model code reads (a ``contextvars.ContextVar``, as
#: ``mesh.py``'s ``_ACTIVE_MESH``)
_ACTIVE: contextvars.ContextVar[Optional[Space]] = contextvars.ContextVar("dgtd_active_space", default=None)


@contextlib.contextmanager
def active_space(layout: Optional[Space]):
    """Make ``layout`` (None: none) the one model code reads."""
    token = _ACTIVE.set(layout)
    try:
        yield layout
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[Space]:
    """The active layout, or None."""
    return _ACTIVE.get()


def split() -> bool:
    """Whether an active layout splits H (space > 1)."""
    sp = _ACTIVE.get()
    return sp is not None and sp.space > 1


def banded(h: int) -> bool:
    """Whether a level of global height ``h`` is banded under the active
    layout: ``space`` divides it (never without a layout, or at space 1)."""
    sp = _ACTIVE.get()
    return sp is not None and sp.space > 1 and h > 0 and h % sp.space == 0


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the active layout's count ``key`` (no-op without one)."""
    sp = _ACTIVE.get()
    if sp is not None:
        sp.counts[key] += int(n)


def refuse_grad(*tensors: torch.Tensor) -> None:
    """The layout is forward only: a tensor that would record a gradient
    through a band's collectives raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the data×space layout is forward only: the adjoints of its halo exchanges and gathers are not "
            "ported yet (ROADMAP A13c); run predict/tensor (inference mode) under it")


def band_rows(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """This rank's rows of a whole tensor along ``dim`` (H: -2 for NCHW, 1
    for NHWC or planes (P, H, W)), when its height is banded; x otherwise."""
    h = x.shape[dim]
    if not banded(h):
        return x
    sp = _ACTIVE.get()
    hb = h // sp.space
    return x.narrow(dim, sp.space_index * hb, hb)


def _through_host(group, x: torch.Tensor) -> bool:
    return dist.get_backend(group) != "nccl" and x.device.type != "cpu"


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` joined along ``dim``, in group order."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=xm.dtype, device=xm.device)
        dist.all_gather_into_tensor(out, xm, group=group)
    else:
        src = xm.cpu() if _through_host(group, xm) else xm
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts).to(x.device)
    count("gathers")
    count("gather_bytes", out.numel() * out.element_size())
    return out.movedim(0, dim).contiguous()


def gather_rows(x: torch.Tensor, global_h: int, dim: int = -2) -> torch.Tensor:
    """The whole level from this rank's band: an all-gather over the space
    group along ``dim`` (rows, or a band's row-major tokens); x itself
    where ``global_h`` is not banded."""
    if not banded(global_h):
        return x
    refuse_grad(x)
    return _all_gather(x, _ACTIVE.get().space_group, dim)


def gather_map(x: torch.Tensor, global_h: int, dim: int = 1) -> torch.Tensor:
    """The whole batch's whole map from this rank's rows and band (e.g.
    ``predict``'s NHWC probability: ``dim`` 1): the rows over the space
    group, then the batch (dim 0) over the data group. x itself without a
    layout."""
    sp = _ACTIVE.get()
    if sp is None:
        return x
    x = gather_rows(x, global_h, dim)
    if sp.data > 1:
        refuse_grad(x)
        x = _all_gather(x, sp.data_group, 0)
    return x


def ring_halo(x: torch.Tensor, top: int, bottom: int, group, dim: int = -2) -> torch.Tensor:
    """``x`` with ``top`` rows of the previous rank of ``group`` above it and
    ``bottom`` rows of the next rank below it along ``dim`` (zeros past the
    first and last rank); each must fit in a neighbour's band. Every rank
    of ``group`` calls it."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    hb = x.shape[dim]
    if top > hb or bottom > hb:
        raise ValueError(f"a halo of {top}/{bottom} rows is taller than a band of {hb}")
    xm = x.movedim(dim, 0)
    above = xm.new_zeros((top, *xm.shape[1:]))
    below = xm.new_zeros((bottom, *xm.shape[1:]))
    sends, recvs = [], []
    if i > 0:
        if bottom:  # my first rows are the previous rank's bottom halo
            sends.append((xm[:bottom].contiguous(), _peer(group, i - 1)))
        if top:
            recvs.append((above, _peer(group, i - 1)))
    if i < n - 1:
        if top:  # my last rows are the next rank's top halo
            sends.append((xm[hb - top:].contiguous(), _peer(group, i + 1)))
        if bottom:
            recvs.append((below, _peer(group, i + 1)))
    host = _through_host(group, x)
    if host:
        sends = [(t.cpu(), p) for t, p in sends]
        landed = [(torch.empty(t.shape, dtype=t.dtype), p) for t, p in recvs]
    else:
        landed = recvs
    if dist.get_backend(group) == "nccl":
        ops = [dist.P2POp(dist.isend, t, p, group) for t, p in sends]
        ops += [dist.P2POp(dist.irecv, t, p, group) for t, p in landed]
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [dist.isend(t, p, group=group) for t, p in sends] + [dist.irecv(t, p, group=group) for t, p in landed]
    for work in works:
        work.wait()
    if host:
        for (dst, _), (src, _) in zip(recvs, landed):
            dst.copy_(src)
    count("halos")
    count("halo_bytes", (above.numel() + below.numel()) * x.element_size())
    return torch.cat([above, xm, below]).movedim(0, dim).contiguous()


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def halo(x: torch.Tensor, top: int, bottom: int, global_h: int, dim: int = -2) -> torch.Tensor:
    """This rank's band of a level of ``global_h`` rows with ``top`` rows
    from above and ``bottom`` from below along ``dim``; rows outside the
    image are zeros. The ring neighbours send them when each halo fits in
    one neighbour's band; a taller halo comes from the gathered level. A
    level that is not banded is padded with zeros."""
    if top == bottom == 0:
        return x
    if not banded(global_h):
        xm = x.movedim(dim, 0)
        return torch.cat([xm.new_zeros((top, *xm.shape[1:])), xm,
                          xm.new_zeros((bottom, *xm.shape[1:]))]).movedim(0, dim).contiguous()
    refuse_grad(x)
    sp = _ACTIVE.get()
    hb = x.shape[dim]
    if top <= hb and bottom <= hb:
        return ring_halo(x, top, bottom, sp.space_group, dim)
    full = gather_rows(x, global_h, dim).movedim(dim, 0)
    padded = torch.cat([full.new_zeros((top, *full.shape[1:])), full, full.new_zeros((bottom, *full.shape[1:]))])
    return padded[sp.space_index * hb: sp.space_index * hb + hb + top + bottom].movedim(0, dim).contiguous()


def conv_out_rows(h: int, kernel: int, stride: int, padding: int, dilation: int = 1) -> int:
    """Output rows of a conv over ``h`` input rows."""
    return (h + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_rows(conv: torch.nn.Conv2d, x: torch.Tensor, global_h: Optional[int]) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` with zero padding) on this rank's share of
    a level of ``global_h`` rows under the active layout.

    On a band it takes ``padding`` rows of halo above and ``kernel − stride
    − padding`` below (zeros only at the image's edges), pads W as the conv
    does, and convolves without H padding: each output row sees the input
    rows that the conv on the whole level gives it. That needs a banded
    input and output, an output of ``global_h/stride`` rows, a band that
    starts on a multiple of the stride and halos no taller than the band.
    Otherwise the conv runs on the gathered level and its output is banded
    again where its level is."""
    if global_h is None:
        raise ValueError("under a data×space layout a conv wider or more strided than 1x1 needs its input's "
                         "global height")
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    d = conv.dilation[0]
    h_out = conv_out_rows(global_h, k, s, p, d)
    hb = x.shape[-2]
    bottom = k - s - p
    if (banded(global_h) and banded(h_out) and h_out * s == global_h and hb % s == 0 and d == 1
            and p <= hb and bottom <= hb and conv.padding_mode == "zeros"):
        xh = halo(x, p, max(bottom, 0), global_h)
        if bottom < 0:
            xh = xh.narrow(-2, 0, xh.shape[-2] + bottom)
        count("banded")
        return F.conv2d(xh, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]), conv.dilation, conv.groups)
    count("replicated")
    full = gather_rows(x, global_h)
    return band_rows(conv._conv_forward(full, conv.weight, conv.bias))


def spatial_mean(x: torch.Tensor, global_h: Optional[int], keepdim: bool = False) -> torch.Tensor:
    """The mean over H and W of an NCHW map at a level of ``global_h``
    rows: on a band, the bands' fp32 means averaged over the space group
    (equal bands), in x's dtype; ``x.mean`` otherwise."""
    if not split() or global_h is None or not banded(global_h):
        if split() and global_h is None:
            raise ValueError("under a data×space layout a spatial mean needs the map's global height")
        return x.mean(dim=(2, 3), keepdim=keepdim)
    refuse_grad(x)
    sp = _ACTIVE.get()
    m = x.float().mean(dim=(2, 3), keepdim=keepdim).contiguous()
    host = _through_host(sp.space_group, m)
    t = m.cpu() if host else m
    dist.all_reduce(t, group=sp.space_group)
    count("reductions")
    return (t.to(x.device) / sp.space).to(x.dtype)


def global_min_max(x: torch.Tensor):
    """The min and max of the whole batch's tensor from this rank's rows
    and band: all-reduces over the space and the data groups (x's own
    without a layout)."""
    sp = _ACTIVE.get()
    lo, hi = x.min(), x.max()
    if sp is None:
        return lo, hi
    refuse_grad(x)
    t = torch.stack([-lo.float(), hi.float()])
    for group, n in ((sp.space_group, sp.space), (sp.data_group, sp.data)):
        if n > 1:
            buf = t.cpu() if _through_host(group, t) else t
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
            count("reductions")
            t = buf.to(x.device)
    return (-t[0]).to(x.dtype), t[1].to(x.dtype)


def full_level(fn, x: torch.Tensor, global_h: int, dim: int = -2) -> torch.Tensor:
    """``fn`` of the whole level (gathered where banded), then this rank's
    band of its result where the result's level is banded: the resizes
    and the FFT under the layout (counted ``full``)."""
    count("full")
    return band_rows(fn(gather_rows(x, global_h, dim)), dim)
