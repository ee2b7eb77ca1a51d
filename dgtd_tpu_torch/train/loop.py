"""Runner: the recipe-driven train loop (counterpart of
``dgtd_tpu/train/loop.py``).

Builds the model, the train loader, the optimizer and the hooks from a
reference-schema recipe, runs the epoch loop with per-step lr, interval
logging to ``work_dir/log.jsonl`` and epoch checkpoints, and resumes exactly,
also from the middle of an epoch. The val pass (and with it ``-m val``)
waits for the val slice: a recipe that would validate during training is
refused before the first step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..core.registry import DATASETS, HOOKS, MODELS
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.loader import DataLoader
from ..models import cod as _cod  # noqa: F401  (registers the models)
from . import hooks as _hooks  # noqa: F401  (registers the hooks)
from .optim import Optimizer
from .state import train_step

VAL_SLICE = "the val pass (val loop, E/F/S/MAE metrics, test.py) comes with a later slice of the port"


class Runner:
    def __init__(self, cfg: dict, work_dir: str = "./output/run", seed: int = 0,
                 device: Optional[torch.device] = None, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.work_dir = work_dir
        self.seed = seed
        self.device = torch.device("cuda") if device is None else torch.device(device)
        tc = cfg.get("train_cfg", {}) or {}
        self.max_epochs = int(tc.get("max_epochs", 1))
        val_interval = int(tc.get("val_interval", self.max_epochs))
        has_val = bool((cfg.get("val_dataloader") or {}).get("dataset"))
        if has_val and 0 < val_interval <= self.max_epochs:
            raise NotImplementedError(
                f"train_cfg.val_interval={val_interval} validates within max_epochs={self.max_epochs}, "
                f"but {VAL_SLICE}; set -o train_cfg.val_interval=0 to train without validation"
            )
        loader_cfg = cfg.get("train_dataloader") or {}
        if "dataset" not in loader_cfg:
            raise ValueError("the recipe has no train_dataloader.dataset")
        self.batch_size = int(loader_cfg.get("batch_size", 1))
        sampler = loader_cfg.get("sampler", {}) or {}
        self.train_loader = DataLoader(
            DATASETS.build(loader_cfg["dataset"]), self.batch_size,
            shuffle=bool(sampler.get("shuffle", True)), seed=seed, drop_last=True, device=self.device,
        )
        self.steps_per_epoch = max(len(self.train_loader), 1)

        self.model = MODELS.build(dict(cfg["model"]), dtype=dtype, seed=seed).to(self.device)
        self.optimizer = Optimizer(self.model.named_parameters(), cfg.get("optim_wrapper", {}) or {},
                                   self.max_epochs, self.steps_per_epoch)
        self.hooks = [HOOKS.build(h) for h in (cfg.get("default_hooks") or {}).values()]
        self.hooks += [HOOKS.build(h) for h in cfg.get("custom_hooks") or []]
        self.hooks.sort(key=lambda h: h.priority)

        self.epoch = 0
        #: train steps taken, the step count of the lr schedule and of the
        #: DropPath generators
        self.host_step = 0
        self.resumed = False
        self._resume_skip = 0
        os.makedirs(work_dir, exist_ok=True)
        self._log_path = os.path.join(work_dir, "log.jsonl")

    def log(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    def save_checkpoint(self, name: str) -> str:
        """``work_dir/<name>.pth`` in MMEngine's layout: ``state_dict`` (the
        reference's key schema), ``optimizer``, ``meta`` (epoch, iter)."""
        path = os.path.abspath(os.path.join(self.work_dir, f"{name}.pth"))
        torch.save({
            "state_dict": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "meta": {"epoch": self.epoch, "iter": self.host_step},
        }, path)
        self.log({"checkpoint": path})
        return path

    def resume(self, path: str) -> None:
        """Restore model, optimizer and step from a checkpoint. A checkpoint
        taken inside an epoch re-enters that epoch and skips the batches it
        already trained: the loader's shuffle and flip streams are keyed by
        epoch, so the skip is exact."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ckpt["state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.host_step = int(ckpt["meta"]["iter"])
        self.epoch = self.host_step // self.steps_per_epoch
        self._resume_skip = self.host_step % self.steps_per_epoch
        self.train_loader.epoch = self.epoch
        self.resumed = True
        self.log({"resumed_at_epoch": self.epoch, "step": self.host_step, "skip_batches": self._resume_skip})

    def train(self) -> Dict[str, Any]:
        """Run the epochs left; returns {"steps", "loop_s"}: the steps this
        call took and the seconds from the first hook to the last."""
        t0, first = time.perf_counter(), self.host_step
        try:
            for h in self.hooks:
                h.before_train(self)
            while self.epoch < self.max_epochs:
                self.epoch += 1
                for h in self.hooks:
                    h.before_train_epoch(self)
                skip, self._resume_skip = self._resume_skip, 0
                for i, batch in enumerate(self.train_loader):
                    if i < skip:
                        continue
                    arrays = {k: batch[k] for k in ("input", "label", "depth")}
                    aux = train_step(self.model, self.optimizer, arrays, self.host_step, self.seed + 1)
                    self.host_step += 1
                    for h in self.hooks:
                        h.after_train_iter(self, aux)
                for h in self.hooks:
                    h.after_train_epoch(self)
        finally:
            for h in self.hooks:
                h.after_train(self)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"steps": self.host_step - first, "loop_s": time.perf_counter() - t0}
