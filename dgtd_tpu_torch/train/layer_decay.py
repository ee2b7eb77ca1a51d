"""Layer-wise lr decay over the PVT backbone (counterpart of
``dgtd_tpu/train/layer_decay.py``).

A recipe opts in with ``optim_wrapper.constructor:
LayerDecayOptimWrapperConstructor`` and ``paramwise_cfg.decay_factor``. The
multiplier of layer ``i`` is ``decay_factor ** (num_layers - i)``: layer 0 is
``patch_embed1``, the blocks count upward in depth order, each stage's patch
embed shares the id of its first block, and everything else (the final
norms, the heads, the prompt modules) is layer ``num_layers``, multiplier 1.
The keys are the port's dotted parameter prefixes and replace the recipe's
``custom_keys``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict

from ..core.registry import OPTIM_CONSTRUCTORS
from ..models.pvt import PVT_V2_CONFIGS


def layer_decay_custom_keys(variant: str = "b2", decay_factor: float = 0.9,
                            prefix: str = "hitnet.backbone") -> Dict[str, float]:
    """lr multipliers by dotted parameter prefix: ``<prefix>.patch_embed{s}``
    and ``<prefix>.block{s}.{i}`` of the PVTv2 ``variant``."""
    depths = PVT_V2_CONFIGS[variant][3]
    num_layers = sum(depths) + 1
    keys = {f"{prefix}.patch_embed1": decay_factor ** num_layers}
    layer = 1
    for s, depth in enumerate(depths):
        if s > 0:
            keys[f"{prefix}.patch_embed{s + 1}"] = decay_factor ** (num_layers - layer)
        for i in range(depth):
            keys[f"{prefix}.block{s + 1}.{i}"] = decay_factor ** (num_layers - layer)
            layer += 1
    return keys


@OPTIM_CONSTRUCTORS.register
def LayerDecayOptimWrapperConstructor(paramwise_cfg: dict, model_cfg: dict) -> Dict[str, float]:
    """The recipe's constructor: the keys of the model's PVT variant at
    ``paramwise_cfg.decay_factor`` (0.9 when not given)."""
    return layer_decay_custom_keys(model_cfg.get("variant", "b2"), float(paramwise_cfg.get("decay_factor", 0.9)))
