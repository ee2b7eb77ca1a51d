"""Data parallelism over ``torch.distributed`` (counterpart of
``dgtd_tpu/parallel/mesh.py`` and ``dgtd_tpu/data/loader.py::local_row_slices``).

The JAX package shards the recipe's batch over a mesh's ``data`` axis and XLA
all-reduces what crosses it. The port runs one process a rank, as the
reference's ``torchrun --nproc_per_node=2`` does, and keeps the JAX
package's semantics: ``batch_size`` is the global batch, rank r of W takes
rows ``[r·B/W, (r+1)·B/W)`` of each (:func:`row_slice`), BatchNorm and
DropPath see the global batch (``models/layers.py``), and the train step
averages the gradients over the ranks (:func:`all_mean_`; under a
data×space layout over the world, :func:`grad_group`).

:func:`init_distributed` starts the process group a launch asks for, from
the same markers as ``initialize_multihost``: an explicit coordinator,
torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``, and SLURM's and OMPI's
sizes, which count only above 1. A single-process run starts no group, and
every function here is then a no-op for one rank.

Host-side agreements (the preemption flag, the val average, the barrier
after a save) go over a CPU gloo group (:func:`side_group`), so that they
never wait on the card's stream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .space import current as current_layout, make_space

#: the CPU gloo group of the host-side agreements, made with the world group
_SIDE = None


def start_space(space):
    """The data×space layout of ``-o dist.space=N`` over the started process
    group (``parallel/space.py::make_space``, data = world / N), or None for
    N = 1. A world that is not a multiple of N, one process included,
    raises."""
    space = int(space)
    if space <= 1:
        return None
    if world() % space:
        raise ValueError(f"dist.space={space} needs a world of data×{space} ranks, got {world()}")
    return make_space(world() // space, space)


@dataclass(frozen=True)
class Launch:
    """What :func:`init_distributed` gives ``init_process_group``."""

    init_method: str
    rank: int
    world_size: int
    local_rank: int


def _env_int(env: Mapping[str, str], var: str, default: int) -> int:
    try:
        return int(env.get(var, default))
    except ValueError:
        return default


_SLURM_SIZES = ("SLURM_JOB_NUM_NODES", "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS")


def _ranks(env: Mapping[str, str]) -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's variables, else from
    SLURM's (the largest of its node, task and step-task counts) or OMPI's,
    the one whose size is above 1 first (``mpirun -np 4`` inside a 1-task
    SLURM job is OMPI's launch); None when no size is set."""
    if "WORLD_SIZE" in env:
        return _env_int(env, "RANK", 0), _env_int(env, "WORLD_SIZE", 1), _env_int(env, "LOCAL_RANK", 0)
    found = []
    sizes = [_env_int(env, v, 1) for v in _SLURM_SIZES if v in env]
    if sizes:
        found.append((_env_int(env, "SLURM_PROCID", 0), max(sizes), _env_int(env, "SLURM_LOCALID", 0)))
    if "OMPI_COMM_WORLD_SIZE" in env:
        found.append((_env_int(env, "OMPI_COMM_WORLD_RANK", 0), _env_int(env, "OMPI_COMM_WORLD_SIZE", 1),
                      _env_int(env, "OMPI_COMM_WORLD_LOCAL_RANK", 0)))
    return max(found, key=lambda f: f[1] > 1) if found else None


def detect_launch(coordinator: Optional[str] = None, env: Optional[Mapping[str, str]] = None) -> Optional[Launch]:
    """The process group this launch asks for, or None for a single-process
    run. Reads only ``coordinator`` and the environment.

    - ``coordinator`` (``host:port``, ``-o dist.coordinator``) is a
      ``tcp://`` rendezvous; rank and size come from the launcher's
      variables (rank 0 of 1 when none is set).
    - torchrun's ``RANK`` and ``WORLD_SIZE`` always start a group, at any
      size (one rank included): ``env://``.
    - SLURM's node, task or step-task count, or OMPI's world size, above 1
      starts one too (``env://``, so ``MASTER_ADDR`` and ``MASTER_PORT`` must
      be set). A 1-task SLURM job or a 1-rank OMPI launch is a plain
      single-process run, as in ``initialize_multihost``; ``srun -N1 -n4``
      (one node, 4 tasks) is a multi-process launch."""
    env = os.environ if env is None else env
    if coordinator:
        return Launch(f"tcp://{coordinator}", *(_ranks(env) or (0, 1, 0)))
    if "RANK" in env and "WORLD_SIZE" in env:
        return Launch("env://", *_ranks(env))
    if any(_env_int(env, v, 1) > 1 for v in _SLURM_SIZES + ("OMPI_COMM_WORLD_SIZE",)):
        return Launch("env://", *_ranks(env))
    return None


def init_distributed(coordinator: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None) -> Tuple[torch.device, bool]:
    """Start the process group of this launch (:func:`detect_launch`);
    returns ``(device, started)``: the device to run on and whether this
    call started the group (its caller destroys it).

    The device is ``device`` when given, else ``cuda:LOCAL_RANK`` under a
    group and ``cuda`` without; a CUDA device without a card raises. The
    backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU. A group
    the caller already started is used as it is. Without a launch no group
    is started."""
    if started():
        return resolve_device(device if device is not None else _default_device(dist.get_rank())), False
    launch = detect_launch(coordinator)
    if launch is None:
        return resolve_device(device), False
    dev = resolve_device(device if device is not None else f"cuda:{launch.local_rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=launch.init_method,
                            rank=launch.rank, world_size=launch.world_size)
    side_group()
    return dev, True


def _default_device(global_rank: int) -> str:
    return f"cuda:{_env_int(os.environ, 'LOCAL_RANK', global_rank % max(torch.cuda.device_count(), 1))}"


def destroy() -> None:
    """Destroy the process group and the side group."""
    global _SIDE
    _SIDE = None
    if started():
        dist.destroy_process_group()


def started() -> bool:
    """Whether a process group exists (one rank under torchrun included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if started() else 0


def world() -> int:
    return dist.get_world_size() if started() else 1


def is_main() -> bool:
    """Rank 0, which writes the run's files (and every single-process run)."""
    return rank() == 0


def data_group():
    """The group a train step's batch is split over: the world group under
    more than one rank, else None (one process computes the global batch).
    Under a data×space layout (``parallel/space.py``) it is the layout's
    data group, never the world."""
    layout = current_layout()
    if layout is not None:
        return layout.data_group
    return dist.group.WORLD if world() > 1 else None


def grad_group():
    """The group a train step averages its gradients and loss terms over:
    the world under a data×space layout (``parallel/space.py``'s
    convention), else :func:`data_group`."""
    if current_layout() is not None:
        return dist.group.WORLD
    return data_group()


def rank_world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def row_slice(batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``batch_size`` split over
    ``world`` ranks: ``[r·B/W, (r+1)·B/W)``, the rows ``local_row_slices``
    gives process r on a ``data`` axis of W devices, one a process. A batch
    that the ranks do not divide raises."""
    if batch_size % world:
        raise ValueError(f"a global batch of {batch_size} does not split evenly over {world} ranks")
    n = batch_size // world
    return slice(rank * n, (rank + 1) * n)


def side_group():
    """The CPU gloo group of the host-side agreements: the world group when
    it is gloo, else a gloo group over the same ranks (made once, by every
    rank: :func:`init_distributed` makes it; a group started by the caller
    gets it at the first call, which every rank must make)."""
    global _SIDE
    if _SIDE is None:
        _SIDE = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return _SIDE


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is true on any rank (a MAX all-reduce on the side
    group; every rank must call it)."""
    if world() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=side_group())
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (on the side group); a no-op for one rank."""
    if world() > 1:
        dist.barrier(group=side_group())


def all_mean(values: Mapping[str, float]) -> Dict[str, float]:
    """The mean over the ranks of each value (float64, on the side group;
    every rank passes the same keys in the same order)."""
    if world() == 1:
        return dict(values)
    keys = list(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, group=side_group())
    return {k: float(v) for k, v in zip(keys, (t / world()).tolist())}


def all_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks of ``group``: one
    all-reduce of a flat buffer a dtype, in the order given (every rank
    passes the same shapes in the same order). The sum is the same on every
    rank, so the results are bit-equal across ranks."""
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is the SUM all-reduce of the gradient,
    as ``torch.distributed.nn.functional.all_reduce`` computes it (which
    recent torch deprecates with a FutureWarning), for the global
    BatchNorm's statistics."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``group``, with its gradient."""
    return _AllReduceSum.apply(tensor, group)


def global_extrema(lo: torch.Tensor, hi: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global batch's min and max from each rank's (no gradient)."""
    t = torch.stack([-lo.detach().float(), hi.detach().float()])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return (-t[0]).to(lo.dtype), t[1].to(hi.dtype)
