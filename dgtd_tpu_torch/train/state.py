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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.trace import span
from ..data.device_norm import normalize_batch
from ..parallel.dist import all_mean_, grad_group


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` only."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()``. On CUDA autograd runs it on a device thread
    whose context holds no data×space layout; a test replaces this to run
    it on a fresh thread on the CPU too."""
    loss.backward()


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], step: int, seed: int) -> Dict[str, torch.Tensor]:
    """Train step ``step`` (0-based) on a batch already on the model's
    device; returns the loss terms (detached device scalars). Each phase
    runs in a ``core/trace.py`` span, the whole step in ``dgtd.train.step``."""
    with span("dgtd.train.step", str(step)):
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
