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
band's.

The train step runs under the layout too (the JAX package's train step
traced under the same mesh), and every collective here has its adjoint.
One convention holds them together:

- The objective is the mean over the world's ranks of each rank's loss.
  The space ranks of a data row all compute their data row's loss, so
  that mean is the global batch's loss.
- Each collective's backward is its transpose: an all-gather
  (:func:`gather_rows`, :func:`gather_map`) reduce-scatters the summed
  gradient, each rank keeping its band; a halo exchange
  (:func:`ring_halo`, :func:`halo`) sends each halo row's gradient back
  to the rank that sent the row, which adds it to its border rows (the
  zeros past the image's edges take none); an all-reduce sum
  (:func:`spatial_mean`, :func:`sum_over_space`: the losses' per-image
  sums over the bands) all-reduces the gradient; :func:`band_rows` (a
  narrow) is autograd's own zero padding.
- After the backward the train step averages every parameter's gradient
  over the whole world, not over the data group
  (``parallel/dist.py::grad_group``). A banded layer's gradient then
  arrives ``space`` times through the transposed all-reduces of a loss
  that every space rank repeats, a replicated layer's once on each of the
  ``space`` ranks, and the world's mean counts each once.

The backward need not run on the caller's thread (on CUDA autograd runs
it on a device thread, whose context holds no layout), so each autograd
Function keeps its group, neighbours and band geometry from the forward
and never reads :func:`current` in backward; ``models/layers.py::
checkpointed`` re-enters the layout for its recompute. The backward's
collectives are counted apart (``grad_exchanges``, ``grad_bytes``).

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
#: means and extrema; the backward's transposed collectives and the bytes
#: each takes in (a reduce-scatter's summed gradient, a halo's returned
#: rows, an all-reduce's tensor)
COUNT_KEYS = ("banded", "replicated", "full", "gathers", "gather_bytes", "halos", "halo_bytes", "reductions",
              "grad_exchanges", "grad_bytes")


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


def _count_grad(sp: Optional[Space], *tensors: torch.Tensor) -> None:
    """Count one of the backward's collectives on ``sp`` (the layout its
    forward ran under; None: none) with the bytes of ``tensors``."""
    if sp is not None:
        sp.counts["grad_exchanges"] += 1
        sp.counts["grad_bytes"] += sum(t.numel() * t.element_size() for t in tensors)


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


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The transpose of :func:`_all_gather`: the sum over ``group`` of
    every rank's ``g``, this rank's equal share of it along ``dim``. NCCL
    reduce-scatters; gloo (which has no reduce-scatter) all-reduces and
    keeps the share."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    gm = g.movedim(dim, 0).contiguous()
    part = gm.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = gm.new_empty((part, *gm.shape[1:]))
        dist.reduce_scatter_tensor(out, gm, group=group)
    else:
        buf = gm.cpu() if _through_host(group, gm) else gm.clone()
        dist.all_reduce(buf, group=group)
        out = buf[i * part:(i + 1) * part].to(g.device)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """:func:`_all_gather` whose backward reduce-scatters the summed
    gradient (each rank keeps its share)."""

    @staticmethod
    def forward(ctx, x, group, dim, sp):
        ctx.group, ctx.dim, ctx.sp = group, dim, sp
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        _count_grad(ctx.sp, g)
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None


def gather_rows(x: torch.Tensor, global_h: int, dim: int = -2) -> torch.Tensor:
    """The whole level from this rank's band: an all-gather over the space
    group along ``dim`` (rows, or a band's row-major tokens); x itself
    where ``global_h`` is not banded. Its backward reduce-scatters the
    summed gradient."""
    if not banded(global_h):
        return x
    sp = _ACTIVE.get()
    return _Gather.apply(x, sp.space_group, dim, sp)


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
        x = _Gather.apply(x, sp.data_group, 0, sp)
    return x


def _exchange(group, sends, recvs, like: torch.Tensor) -> None:
    """Post every send ((tensor, global peer)) and receive into every
    buffer of ``recvs`` at once, then wait for all: NCCL on the device
    (``batch_isend_irecv``), gloo on host copies of CUDA tensors."""
    host = _through_host(group, like)
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


def _ring_peers(group):
    """(previous, next) global ranks of this rank in ``group``'s ring (None
    past the first and the last)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return (_peer(group, i - 1) if i > 0 else None), (_peer(group, i + 1) if i < n - 1 else None)


def _ring_halo(x: torch.Tensor, top: int, bottom: int, group, dim: int, peers) -> torch.Tensor:
    hb = x.shape[dim]
    prev, nxt = peers
    xm = x.movedim(dim, 0)
    above = xm.new_zeros((top, *xm.shape[1:]))
    below = xm.new_zeros((bottom, *xm.shape[1:]))
    sends, recvs = [], []
    if prev is not None:
        if bottom:  # my first rows are the previous rank's bottom halo
            sends.append((xm[:bottom].contiguous(), prev))
        if top:
            recvs.append((above, prev))
    if nxt is not None:
        if top:  # my last rows are the next rank's top halo
            sends.append((xm[hb - top:].contiguous(), nxt))
        if bottom:
            recvs.append((below, nxt))
    _exchange(group, sends, recvs, x)
    count("halos")
    count("halo_bytes", sum(t.numel() for t, _ in recvs) * x.element_size())
    return torch.cat([above, xm, below]).movedim(0, dim).contiguous()


class _RingHalo(torch.autograd.Function):
    """:func:`_ring_halo` whose backward returns each halo row's gradient
    to the rank that sent the row: the top halo's to the previous rank,
    which adds it to its last ``top`` rows, the bottom halo's to the next,
    which adds it to its first ``bottom`` rows (the mirror of the forward's
    sends and receives; the edge ranks' zero rows send nothing)."""

    @staticmethod
    def forward(ctx, x, top, bottom, group, dim, peers, sp):
        ctx.top, ctx.bottom, ctx.hb, ctx.group, ctx.dim, ctx.peers, ctx.sp = (
            top, bottom, x.shape[dim], group, dim, peers, sp)
        return _ring_halo(x, top, bottom, group, dim, peers)

    @staticmethod
    def backward(ctx, g):
        top, bottom, hb = ctx.top, ctx.bottom, ctx.hb
        prev, nxt = ctx.peers
        gm = g.movedim(ctx.dim, 0)
        dx = gm[top:top + hb].clone()
        from_next = dx.new_empty((top, *dx.shape[1:]))
        from_prev = dx.new_empty((bottom, *dx.shape[1:]))
        sends, recvs = [], []
        if prev is not None:
            if top:  # the previous rank's last rows were my top halo
                sends.append((gm[:top].contiguous(), prev))
            if bottom:
                recvs.append((from_prev, prev))
        if nxt is not None:
            if bottom:  # the next rank's first rows were my bottom halo
                sends.append((gm[top + hb:].contiguous(), nxt))
            if top:
                recvs.append((from_next, nxt))
        _exchange(ctx.group, sends, recvs, g)
        if prev is not None and bottom:
            dx[:bottom] += from_prev
        if nxt is not None and top:
            dx[hb - top:] += from_next
        _count_grad(ctx.sp, *(t for t, _ in recvs))
        return dx.movedim(0, ctx.dim).contiguous(), None, None, None, None, None, None


def ring_halo(x: torch.Tensor, top: int, bottom: int, group, dim: int = -2) -> torch.Tensor:
    """``x`` with ``top`` rows of the previous rank of ``group`` above it and
    ``bottom`` rows of the next rank below it along ``dim`` (zeros past the
    first and last rank); each must fit in a neighbour's band. Every rank
    of ``group`` calls it. Its backward sends the halo rows' gradient back
    (:class:`_RingHalo`)."""
    hb = x.shape[dim]
    if top > hb or bottom > hb:
        raise ValueError(f"a halo of {top}/{bottom} rows is taller than a band of {hb}")
    return _RingHalo.apply(x, top, bottom, group, dim, _ring_peers(group), _ACTIVE.get())


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


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.cpu() if _through_host(group, x) else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


class _SumOver(torch.autograd.Function):
    """A SUM all-reduce over ``group`` whose backward all-reduces the
    gradient."""

    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        _count_grad(ctx.sp, g)
        return _all_reduce_sum(g, ctx.group), None, None


def sum_over_space(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active layout's space group, with its
    gradient (the losses' per-image sums over the bands); x itself where
    the layout does not split H."""
    if not split():
        return x
    sp = _ACTIVE.get()
    count("reductions")
    return _SumOver.apply(x, sp.space_group, sp)


def spatial_mean(x: torch.Tensor, global_h: Optional[int], keepdim: bool = False) -> torch.Tensor:
    """The mean over H and W of an NCHW map at a level of ``global_h``
    rows: on a band, the bands' fp32 means summed over the space group
    (:func:`sum_over_space`) and divided by ``space`` (equal bands), in x's
    dtype; ``x.mean`` otherwise."""
    if not split() or global_h is None or not banded(global_h):
        if split() and global_h is None:
            raise ValueError("under a data×space layout a spatial mean needs the map's global height")
        return x.mean(dim=(2, 3), keepdim=keepdim)
    m = x.float().mean(dim=(2, 3), keepdim=keepdim).contiguous()
    return (sum_over_space(m) / _ACTIVE.get().space).to(x.dtype)


def global_min_max(x: torch.Tensor):
    """The min and max of the whole batch's tensor from this rank's rows
    and band: all-reduces over the space and the data groups (x's own
    without a layout). They carry no gradient: they only normalize the
    texture, an FFT of the input (``models/losses.py``)."""
    sp = _ACTIVE.get()
    lo, hi = x.min(), x.max()
    if sp is None:
        return lo, hi
    t = torch.stack([-lo.detach().float(), hi.detach().float()])
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
