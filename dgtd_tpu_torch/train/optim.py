"""AdamW with the recipe's per-module lr multipliers, a cosine schedule by
epoch, and gradient clipping (counterpart of ``dgtd_tpu/train/optim.py``).

The port's parameter names are the reference's dotted names
(``hitnet.backbone.prompt_encoder.encoder2.stages.2...``), so the recipe's
``paramwise_cfg.custom_keys`` match them as they stand: the longest key that
is a dotted prefix of a name sets its multiplier, and a key that matches no
parameter raises. Weight decay applies to every parameter, as ``optax.adamw``
with no mask does, except the frozen ones. The lr of each group is set before
every step from the step count, so a resumed run needs no scheduler state.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import torch


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


def _custom_keys(optim_cfg: dict) -> Dict[str, float]:
    custom = (optim_cfg.get("paramwise_cfg") or {}).get("custom_keys") or {}
    return {k: float(v.get("lr_mult", 1.0)) if isinstance(v, dict) else float(v) for k, v in custom.items()}


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
    module ran."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], optim_cfg: dict,
                 max_epochs: int, steps_per_epoch: int, frozen_prefixes: Sequence[str] = ()):
        opt = optim_cfg.get("optimizer", {})
        if opt.get("type", "AdamW") != "AdamW":
            raise ValueError(f"only AdamW recipes are supported, got {opt.get('type')!r}")
        self.base_lr = float(opt.get("lr", 5e-4))
        self.max_epochs = int(max_epochs)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        keys = _custom_keys(optim_cfg)
        named = [(n, p) for n, p in named_params if p.requires_grad]
        unmatched = [k for k in keys if not any(n == k or n.startswith(k + ".") for n, _ in named)]
        if unmatched:
            raise ValueError(f"paramwise_cfg.custom_keys entries match no parameter: {unmatched}")
        frozen = tuple(frozen_prefixes)
        self.frozen = [(n, p) for n, p in named if n.startswith(frozen)]
        named = [(n, p) for n, p in named if not n.startswith(frozen)]
        groups: Dict[float, list] = {}
        for n, p in named:
            groups.setdefault(lr_mult(n, keys), []).append(p)
        self.params = [p for _, p in named]
        self.opt = torch.optim.AdamW(
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
