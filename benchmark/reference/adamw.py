"""AdamW as ``torch.optim.AdamW`` defines it (decoupled weight decay,
bias-corrected moments, eps outside the square root), with the recipe's lr
multipliers and its cosine schedule by epoch, and the reference's train
step built on it.

A parameter's lr is the base lr times the multiplier of the longest
``custom_keys`` entry that is its name or a dotted prefix of it (1.0 when
none is), times ½(1 + cos(π·epoch/max_epochs)), the epoch being
step // steps_per_epoch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .losses import model_loss
from .models import forward
from .numerics import Numerics
from .ops import step_generator


def lr_multiplier(name: str, custom_keys: Dict[str, float]) -> float:
    best, mult = -1, 1.0
    for key, m in custom_keys.items():
        if (name == key or name.startswith(key + ".")) and len(key) > best:
            best, mult = len(key), float(m)
    return mult


def scheduled_lr(step: int, base_lr: float, max_epochs: int, steps_per_epoch: int) -> float:
    epoch = min(step // steps_per_epoch, max_epochs)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epochs))


class AdamW:
    """The optimizer over the named float leaves of a state dict."""

    def __init__(self, params: Dict[str, torch.Tensor], optim: dict):
        opt = optim["optimizer"]
        self.base_lr, self.wd = float(opt["lr"]), float(opt["weight_decay"])
        self.b1, self.b2 = (float(b) for b in opt.get("betas", (0.9, 0.999)))
        self.eps = 1e-8
        keys = optim.get("custom_keys", {})
        self.mult = {n: lr_multiplier(n, keys) for n in params}
        self.params = params
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads.get(n)
            if g is None:
                continue
            a = lr * self.mult[n]
            p.mul_(1.0 - a * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-a / bc1)


def train_steps(arch: dict, optim: dict, schedule: dict, P: Dict[str, torch.Tensor], batches, seed: int,
                nx: Numerics = None, on_grads=None):
    """Train steps 0, 1, ... on ``batches`` (dicts of NCHW float ``input``,
    ``depth``, ``label``) from the state dict ``P`` (updated in place; its
    float leaves are the parameters, the BatchNorm statistics excepted).
    Returns each step's loss terms (floats). ``on_grads(step, grads)`` sees
    each step's gradients before the update."""
    nx = nx or Numerics()
    params = {n: t for n, t in P.items() if t.is_floating_point() and not n.endswith(("running_mean", "running_var"))}
    opt = AdamW(params, optim)
    losses = []
    for step, batch in enumerate(batches):
        leaves = {n: t.detach().requires_grad_(True) for n, t in params.items()}
        full = {**P, **leaves}
        gen = step_generator(seed, step, batch["input"].device)
        out = forward(arch, full, batch["input"], batch["depth"], train=True, gen=gen, nx=nx)
        total, terms = model_loss(arch, out, batch["input"], batch["label"])
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
        grads = {n: g for n, g in zip(names, grads) if g is not None}
        del out, total, full, leaves
        if on_grads is not None:
            on_grads(step, grads)
        opt.step(grads, scheduled_lr(step, opt.base_lr, schedule["max_epochs"], schedule["steps_per_epoch"]))
        losses.append({k: float(v.detach()) for k, v in terms.items()})
    return losses
