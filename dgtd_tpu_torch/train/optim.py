"""AdamW with the recipe's per-module lr multipliers, a cosine schedule by
epoch, and gradient clipping (counterpart of ``dgtd_tpu/train/optim.py``).

The port's parameter names are the reference's dotted names
(``hitnet.backbone.prompt_encoder.encoder2.stages.2...``), so the recipe's
``paramwise_cfg.custom_keys`` match them as they stand: the longest key that
is a dotted prefix of a name sets its multiplier, and a key that matches no
parameter raises. Weight decay applies to every parameter, as ``optax.adamw``
with no mask does, except the frozen ones. The lr of each group is set before
every step from the step count, so a resumed run needs no scheduler state.

``optim_wrapper.constructor`` names a registered key constructor (the layer
decay of ``train/layer_decay.py``) whose keys replace ``custom_keys``; an
unknown name raises. ``optim_wrapper.bf16_state: true`` stores AdamW's m and
v in bf16 (:class:`AdamWBf16State`), as the JAX package's
``scale_by_adam_bf16`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.registry import OPTIM_CONSTRUCTORS
from . import layer_decay as _layer_decay  # noqa: F401  (registers the constructor)
from .state import step_generator

#: the fixed seed of the stochastic rounding's generator (with the step)
BF16_STATE_SEED = 0x5EED


def lr_mult(name: str, custom_keys: Dict[str, float]) -> float:
    """The multiplier of the longest key that is ``name`` or a dotted prefix
    of it; 1.0 when none is."""
    best_len, mult = -1, 1.0
    for key, m in custom_keys.items():
        if (name == key or name.startswith(key + ".")) and len(key) > best_len:
            best_len, mult = len(key), m
    return mult


def cosine_epoch_lr(step: int, base_lr: float, max_epochs: int, steps_per_epoch: int,
                    eta_min: float = 0.0) -> float:
    """CosineAnnealingLR stepped per epoch (T_max = max_epochs)."""
    epoch = min(step // steps_per_epoch, max_epochs)
    return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epochs))


def _custom_keys(optim_cfg: dict, model_cfg: dict) -> Tuple[Dict[str, float], bool]:
    """The lr multipliers by parameter prefix, and whether a constructor made
    them (its keys enumerate layers, so a key may match nothing)."""
    paramwise = optim_cfg.get("paramwise_cfg") or {}
    if optim_cfg.get("constructor"):
        return OPTIM_CONSTRUCTORS.get(optim_cfg["constructor"])(paramwise, model_cfg), True
    custom = paramwise.get("custom_keys") or {}
    return {k: float(v.get("lr_mult", 1.0)) if isinstance(v, dict) else float(v) for k, v in custom.items()}, False


def stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """fp32 -> bf16, rounded up with the probability of the dropped fraction:
    16 random low bits added to the fp32 bits before they are cut (the JAX
    package's ``stochastic_round_bf16``). Non-finite values pass through."""
    x32 = x.float().contiguous()
    rnd = torch.randint(0, 1 << 16, x32.shape, generator=generator, dtype=torch.int32, device=x32.device)
    # finite fp32 bits plus 0xFFFF stay below 2^31: no int32 overflow
    rounded = ((x32.view(torch.int32) + rnd) & -65536).view(torch.float32)
    return torch.where(torch.isfinite(x32), rounded, x32).to(torch.bfloat16)


def adam_bf16_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int, b1: float, b2: float,
                     eps: float, generator: torch.Generator):
    """One Adam step on bf16 moments, computed in fp32 as
    ``scale_by_adam_bf16`` computes it: returns the update m̂ / (√v̂ + eps)
    (fp32), m rounded to nearest and v stochastically rounded (bf16)."""
    g32 = g.float()
    m32 = m.float() * b1 + g32 * (1.0 - b1)
    v32 = v.float() * b2 + g32 * (1.0 - b2) * g32
    # the bias corrections in fp32, as optax computes them (1 - 0.999 in
    # double is 1.3e-5 off the fp32 one, 6e-6 of the update at step 1)
    one, c = np.float32(1.0), np.float32(count)
    bc1, bc2 = float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c)
    update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    return update, m32.to(torch.bfloat16), stochastic_round_bf16(v32, generator)


class AdamWBf16State(torch.optim.Optimizer):
    """AdamW whose m and v are stored in bf16 and computed in fp32 (the JAX
    package's ``scale_by_adam_bf16`` followed by ``add_decayed_weights`` and
    the lr, as ``optax.adamw`` places them): ``p -= lr · (update + wd · p)``.
    The rounding's random bits come from a generator on the parameters'
    device seeded from ``BF16_STATE_SEED`` and the step count alone, so a
    resumed run rounds as the uninterrupted one does. The moments go into
    ``state_dict`` in bf16 and come back in bf16."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay, count=0))

    @torch.no_grad()
    def step(self):
        count = self.param_groups[0]["count"] + 1
        params = [p for g in self.param_groups for p in g["params"]]
        gen = step_generator(BF16_STATE_SEED, count, params[0].device) if params else None
        for group in self.param_groups:
            group["count"] = count
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                update, st["exp_avg"], st["exp_avg_sq"] = adam_bf16_update(
                    p.grad, st["exp_avg"], st["exp_avg_sq"], count, b1, b2, group["eps"], gen)
                p.add_(update + group["weight_decay"] * p, alpha=-group["lr"])

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        # torch.optim casts a loaded state to its parameter's dtype
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(torch.bfloat16)


class Optimizer:
    """``torch.optim.AdamW`` over one param group per lr multiplier, built
    from a reference-schema ``optim_wrapper`` block. :meth:`step` sets every
    group's lr for the step, clips, steps and clears the gradients.

    ``frozen_prefixes`` (a model's ``frozen_param_prefixes``) name the
    parameters the forward never uses: they stay out of the param groups and
    the clipping, so they take no update and no weight decay and stay
    bit-identical, as under the reference's DDP with
    ``find_unused_parameters=True``. ``custom_keys`` may still name them. A
    frozen parameter that receives a gradient raises at the step: its
    module ran. ``model_cfg`` (the recipe's ``model`` block) is what a
    ``constructor`` reads."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], optim_cfg: dict,
                 max_epochs: int, steps_per_epoch: int, frozen_prefixes: Sequence[str] = (),
                 model_cfg: Optional[dict] = None):
        opt = optim_cfg.get("optimizer", {})
        if opt.get("type", "AdamW") != "AdamW":
            raise ValueError(f"only AdamW recipes are supported, got {opt.get('type')!r}")
        self.base_lr = float(opt.get("lr", 5e-4))
        self.max_epochs = int(max_epochs)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        keys, constructed = _custom_keys(optim_cfg, model_cfg or {})
        named = [(n, p) for n, p in named_params if p.requires_grad]
        unmatched = [] if constructed else [
            k for k in keys if not any(n == k or n.startswith(k + ".") for n, _ in named)]
        if unmatched:
            raise ValueError(f"paramwise_cfg.custom_keys entries match no parameter: {unmatched}")
        frozen = tuple(frozen_prefixes)
        self.frozen = [(n, p) for n, p in named if n.startswith(frozen)]
        named = [(n, p) for n, p in named if not n.startswith(frozen)]
        groups: Dict[float, list] = {}
        for n, p in named:
            groups.setdefault(lr_mult(n, keys), []).append(p)
        self.params = [p for _, p in named]
        self.bf16_state = bool(optim_cfg.get("bf16_state", False))
        self.opt = (AdamWBf16State if self.bf16_state else torch.optim.AdamW)(
            [{"params": ps, "lr_mult": m} for m, ps in sorted(groups.items())],
            lr=self.base_lr, betas=tuple(opt.get("betas", (0.9, 0.999))), eps=1e-8,
            weight_decay=float(opt.get("weight_decay", 0.1)),
        )
        self.clip_value = self.max_norm = None
        cg = optim_cfg.get("clip_grad")
        if cg:
            if cg.get("clip_value") is not None:
                self.clip_value = float(cg["clip_value"])
            elif cg.get("max_norm") is not None:
                self.max_norm = float(cg["max_norm"])
            else:
                raise ValueError(f"clip_grad must set clip_value or max_norm, got: {cg}")

    def lr(self, step: int) -> float:
        return cosine_epoch_lr(step, self.base_lr, self.max_epochs, self.steps_per_epoch)

    def step(self, step: int) -> None:
        """Apply the gradients of train step ``step`` (0-based)."""
        ran = [n for n, p in self.frozen if p.grad is not None]
        if ran:
            raise RuntimeError(f"{len(ran)} frozen parameters received a gradient (first: {ran[:3]}): "
                               "the forward ran a module it should skip")
        if self.clip_value is not None:
            torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        if self.max_norm is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.max_norm)
        lr = self.lr(step)
        for group in self.opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state):
        self.opt.load_state_dict(state)
