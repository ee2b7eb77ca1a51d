"""One train step (counterpart of ``dgtd_tpu/train/state.py::make_train_step``).

normalize the batch -> forward and loss (bf16 autocast unless the model runs
fp32; parameters stay fp32) -> ``loss.backward()`` -> clip, AdamW step, clear
the gradients. DropPath draws from a generator seeded from ``(seed, step)``
alone, like the JAX package's ``fold_in(train_rng, step)``: a resumed run
needs no generator state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.device_norm import normalize_batch


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` only."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], step: int, seed: int) -> Dict[str, torch.Tensor]:
    """Train step ``step`` (0-based) on a batch already on the model's
    device; returns the loss terms (detached device scalars)."""
    batch = normalize_batch(batch)
    gen = step_generator(seed, step, batch["input"].device)
    loss, aux = model.loss(batch["input"], batch["depth"], batch["label"], generator=gen)
    loss.backward()
    optimizer.step(step)
    return {k: v.detach() for k, v in aux.items()}
