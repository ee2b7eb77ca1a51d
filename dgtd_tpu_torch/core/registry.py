"""Name -> class registries (counterpart of ``dgtd_tpu/core/registry.py``):
recipes name components by ``type:``."""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Any] = {}

    def register(self, obj: Any):
        key = obj.__name__
        if key in self._store and self._store[key] is not obj:
            raise KeyError(f"{self.name}: duplicate registration for {key!r}")
        self._store[key] = obj
        return obj

    def get(self, key: str) -> Any:
        if key not in self._store:
            raise KeyError(
                f"{self.name}: unknown type {key!r}. Registered: {sorted(self._store)}"
            )
        return self._store[key]

    def build(self, cfg: dict, **extra) -> Any:
        """Instantiate from a ``{'type': Name, **kwargs}`` config block."""
        cfg = dict(cfg)
        if "type" not in cfg:
            raise KeyError(f"{self.name}: config block has no 'type' key: {cfg!r}")
        return self.get(cfg.pop("type"))(**cfg, **extra)


MODELS = Registry("models")
DATASETS = Registry("datasets")
HOOKS = Registry("hooks")
METRICS = Registry("metrics")
VIS_BACKENDS = Registry("vis_backends")
OPTIM_CONSTRUCTORS = Registry("optim_constructors")
