"""One train step (counterpart of ``dgtd_tpu/train/state.py::make_train_step``).

normalize the batch -> forward and loss (bf16 autocast unless the model runs
fp32; parameters stay fp32) -> ``loss.backward()`` -> clip, AdamW step, clear
the gradients. DropPath draws from a generator seeded from ``(seed, step)``
alone, like the JAX package's ``fold_in(train_rng, step)``: a resumed run
needs no generator state.

Under data parallelism the batch is this rank's rows of the global batch.
After the backward the gradients and the loss terms are averaged over the
ranks (one all-reduce), so every rank clips and steps the global batch's
gradient, as the JAX step's XLA all-reduce gives it, and the parameters
stay bit-equal across ranks. Under a data×space layout the batch is this
rank's data row's rows, ``loss`` bands them, and the average is over the
whole world (``parallel/space.py``'s convention: the space ranks of a row
repeat its loss). Only the gradients that exist are averaged:
those of the modules the forward never runs (the dead and frozen prefixes)
stay None on every rank.

**CUDA graphs.** Where :func:`eager_reason` finds nothing against it (one
process on a card, torch AdamW, no checkpointed block, anomaly mode off),
the step is captured in three CUDA graphs that share one memory pool and
replayed, one launch a phase in place of thousands (:class:`GraphedStep`):
the first step of a batch signature (the shapes and dtypes of ``input``,
``depth`` and ``label``) runs eagerly on a side stream, the second captures
and replays, every later one replays. One signature is captured per
optimizer, the first that comes twice in a row; after it a batch of
another shape (a loader's last partial batch) runs eagerly. The replayed
step computes what the eager one does: the same kernels, the hand-written
ones included, the DropPath masks of ``(seed, step)``, AdamW's fused
update on both paths.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import flags
from ..core.trace import span
from ..data.device_norm import normalize_batch
from ..parallel import space
from ..parallel.dist import all_mean_, grad_group

#: train steps that replayed the captured graphs, and that ran eagerly (on
#: the CPU, a warm-up, a batch of another shape, a step that cannot be captured)
GRAPH_STEPS = 0
EAGER_STEPS = 0
#: captures made: each calls the kernel wrappers once, as an eager step
#: does, so the ``ops/`` launch counters count ``EAGER_STEPS + CAPTURES``
#: steps' launches
CAPTURES = 0
#: the batch keys a step reads
INPUTS = ("input", "depth", "label")


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s DropPath generator."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` only."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    return gen


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()``. On CUDA autograd runs it on a device thread
    whose context holds no data×space layout; a test replaces this to run
    it on a fresh thread on the CPU too."""
    loss.backward()


def eager_reason(model, optimizer, device: torch.device) -> Optional[str]:
    """What keeps a step of ``model`` on ``device`` out of CUDA graphs, or
    None where it can be captured: graphs exist on a card only; an
    all-reduce, a data×space layout's exchanges, ``AdamWBf16State``'s host
    bias corrections and rounding generator, a checkpointed block's
    generator states read and put back on the host, and anomaly mode's
    checks (``debug_nans``) each need the host inside the step."""
    if device.type != "cuda":
        return "not a CUDA device"
    if grad_group() is not None:
        return "a gradient group"
    if space.current() is not None:
        return "a data×space layout"
    opt = getattr(optimizer, "opt", None)
    if not isinstance(opt, torch.optim.AdamW):
        return "not torch AdamW"
    if not opt.defaults["capturable"]:
        return "AdamW not capturable"
    if any(getattr(m, "remat", False) for m in model.modules()):
        return "a checkpointed block"
    if torch.is_anomaly_enabled():
        return "anomaly mode"
    return None


def eager_step(model, optimizer, batch, step: int, seed: int) -> Dict[str, torch.Tensor]:
    """The step as it runs outside CUDA graphs, each phase launched from the
    host; returns the loss terms."""
    with span("dgtd.train.normalize"):
        batch = normalize_batch(batch)
    gen = step_generator(seed, step, batch["input"].device)
    with span("dgtd.train.forward"):
        loss, aux = model.loss(batch["input"], batch["depth"], batch["label"], generator=gen)
    with span("dgtd.train.backward"):
        backward(loss)
    aux = {k: v.detach() for k, v in aux.items()}
    group = grad_group()
    if group is not None:
        aux = {k: v.clone() for k, v in aux.items()}
        with span("dgtd.train.all_reduce"):
            all_mean_([p.grad for p in model.parameters() if p.grad is not None] + list(aux.values()), group)
    with span("dgtd.train.optimizer"):
        optimizer.step(step)
    return aux


def capture(graph: torch.cuda.CUDAGraph, pool, stream: torch.cuda.Stream, fn) -> Any:
    """Capture ``fn()`` into ``graph`` on ``stream`` in the memory ``pool``;
    returns what ``fn`` returned. Only this thread's calls are held to the
    capture's rules (``thread_local``): a loader's thread may pin memory
    meanwhile."""
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        return fn()


class GraphedStep:
    """The train step of one model and optimizer at one batch signature, as
    three CUDA graphs in one memory pool: (a) normalize, ``model.loss`` and
    its terms; (b) the backward; (c) the optimizer's clip and AdamW update
    (:meth:`Optimizer.update`). Each replays inside the span it replaces, (c)
    inside ``Optimizer.step``, so the spans' device time reads as the eager
    step's. Replays read the batch from static input buffers (a copy on the
    card a step) and return the loss terms cloned. DropPath draws from one
    generator registered with the capture and seeded before each replay
    with :func:`step_seed`, so the masks of step ``s`` are the eager step
    ``s``'s. The gradients live in the pool between (b) and (c); the
    parameters' ``.grad`` are dropped after (c) as after an eager update,
    so an eager step never adds into them. The ``ops/`` launch counters
    count their wrappers' calls, the capture's included; a replay calls no
    wrapper, and its kernels show in a profiler trace under the replay's
    ``cudaGraphLaunch``."""

    def __init__(self, model, signature: tuple, device: torch.device):
        self.model, self.signature = model, signature
        self.stream = torch.cuda.Stream(device)
        self.warmed = False
        self.phases: Optional[Tuple[torch.cuda.CUDAGraph, ...]] = None

    def warm_up(self, optimizer, batch, step: int, seed: int) -> Dict[str, torch.Tensor]:
        """The signature's first step, eager on the capture's side stream:
        cuDNN and cuFFT plans, AdamW's state and the device constants are
        made here, outside any capture."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            aux = eager_step(self.model, optimizer, batch, step, seed)
        current.wait_stream(self.stream)
        self.warmed = True
        return aux

    def capture(self, optimizer, batch) -> None:
        """Record the three graphs; nothing runs, so no update is applied."""
        global CAPTURES
        CAPTURES += 1
        self.inputs = {k: torch.empty_like(batch[k]) for k in INPUTS}
        self.generator = torch.Generator(device=batch["input"].device)
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        graphs[0].register_generator_state(self.generator)
        pool = torch.cuda.graph_pool_handle()
        self.stream.wait_stream(torch.cuda.current_stream())

        def forward():
            b = normalize_batch(self.inputs)
            loss, aux = self.model.loss(b["input"], b["depth"], b["label"], generator=self.generator)
            return loss, {k: v.detach() for k, v in aux.items()}

        loss, self.aux = capture(graphs[0], pool, self.stream, forward)
        capture(graphs[1], pool, self.stream, lambda: backward(loss))
        # the backward's outputs, read by (c) and written by every replay of (b)
        self.grads = [p.grad for p in optimizer.params]
        capture(graphs[2], pool, self.stream, optimizer.update)
        self.phases = tuple(graphs)

    def run(self, optimizer, batch, step: int, seed: int) -> Dict[str, torch.Tensor]:
        fwd, bwd, upd = self.phases
        with span("dgtd.train.normalize"):
            for k in INPUTS:
                self.inputs[k].copy_(batch[k])
        with span("dgtd.train.forward"):
            self.generator.manual_seed(step_seed(seed, step))
            fwd.replay()
            aux = {k: v.clone() for k, v in self.aux.items()}
        with span("dgtd.train.backward"):
            bwd.replay()
        with span("dgtd.train.optimizer"):
            optimizer.step(step, upd)
        return aux


def _graphed_step(model, optimizer, batch) -> Optional[GraphedStep]:
    """The optimizer's :class:`GraphedStep` for this model and batch
    signature (the inputs' shapes, dtypes and device, and the stencil's
    layout flag, which picks the kernels a capture holds), made anew while
    the one it holds has captured nothing (a run that starts on a last
    partial batch captures the next signature); None where it holds the
    graphs of another model or signature."""
    signature = (flags.diffusion_plane_layout,) + tuple(
        (k, tuple(batch[k].shape), batch[k].dtype, batch[k].device) for k in INPUTS)
    graphed = optimizer.graphed
    same = graphed is not None and graphed.model is model and graphed.signature == signature
    if not same and (graphed is None or graphed.phases is None):
        graphed = optimizer.graphed = GraphedStep(model, signature, batch["input"].device)
        same = True
    return graphed if same else None


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], step: int, seed: int) -> Dict[str, torch.Tensor]:
    """Train step ``step`` (0-based) on a batch already on the model's
    device; returns the loss terms (detached device scalars). Each phase
    runs in a ``core/trace.py`` span, the whole step in ``dgtd.train.step``,
    whose args are the step index and ``graph`` or ``eager``."""
    global GRAPH_STEPS, EAGER_STEPS
    graphed = None
    if eager_reason(model, optimizer, batch["input"].device) is None:
        graphed = _graphed_step(model, optimizer, batch)
    replay = graphed is not None and graphed.warmed
    with span("dgtd.train.step", f"{step} {'graph' if replay else 'eager'}"):
        if not replay:
            EAGER_STEPS += 1
            if graphed is None:
                return eager_step(model, optimizer, batch, step, seed)
            return graphed.warm_up(optimizer, batch, step, seed)
        if graphed.phases is None:
            graphed.capture(optimizer, batch)
        GRAPH_STEPS += 1
        return graphed.run(optimizer, batch, step, seed)
