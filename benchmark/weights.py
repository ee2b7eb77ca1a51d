"""The seeded weights that both sides receive.

One state dict, made on the device from ``--seed`` in a few large calls:
one ``torch.randn`` over every float tensor of the model's state dict
(``reference.models.spec`` lists them), scaled and shifted element-wise by
each tensor's kind, then cut into views. The program gets it through
``load_state_dict``; the reference makes it again from the same seed after
the window and computes on it. Float32: the master weights the
configurations train and serve.

Kinds: a weight N(0, 1/fan_in) (fan-in of the conv or linear layer); a bias
N(0, 0.02²); norm weights 1 + N(0, 0.1²) and biases N(0, 0.1²); BatchNorm
running means N(0, 0.1²) and variances 1 + N(0, 0.1²); ConvNeXt's layer
scale 0.1 + N(0, 0.02²); PReLU slopes 0.25 + N(0, 0.05²); counters 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference.models import fan_in_std, spec

#: elements a tensor's span in the buffer is rounded up to (256 bytes)
ALIGN = 64
#: (std, mean) of each kind of float tensor
KINDS = {
    "bias": (0.02, 0.0),
    "norm_weight": (0.1, 1.0),
    "norm_bias": (0.1, 0.0),
    "running_mean": (0.1, 0.0),
    "running_var": (0.1, 1.0),
    "layer_scale": (0.02, 0.1),
    "prelu": (0.05, 0.25),
}


def make_state(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's state dict for ``seed``, float32 on ``device``; every
    tensor starts on a 256-byte boundary of the one buffer, as a tensor
    of its own would (vectorized kernels need it)."""
    items = spec(arch)
    floats = [(n, s, k, f) for n, s, k, f in items if k != "count"]
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in floats]
    stds = [fan_in_std(f) if k == "weight" else KINDS[k][0] for _, _, k, f in floats]
    means = [0.0 if k == "weight" else KINDS[k][1] for _, _, k, _ in floats]
    spans = [-(-n // ALIGN) * ALIGN for n in sizes]
    counts = torch.tensor(spans, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(spans), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), counts))
    state, off = {}, 0
    for (name, shape, _, _), n, span in zip(floats, sizes, spans):
        state[name] = flat[off:off + n].view(shape)
        off += span
    for name, shape, kind, _ in items:
        if kind == "count":
            state[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return state


def n_parameters(arch: dict) -> int:
    """Parameters of the model (its float tensors but BatchNorm's running
    statistics)."""
    return sum(int(torch.Size(s).numel()) for n, s, k, _ in spec(arch)
               if k not in ("count", "running_mean", "running_var"))
