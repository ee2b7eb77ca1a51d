"""Runner: the recipe-driven train and val loops (counterpart of
``dgtd_tpu/train/loop.py``).

Builds the model, the loaders, the optimizer, the hooks, the evaluators and
the visualization backends from a reference-schema recipe. ``train()`` runs
the epoch loop with per-step lr, interval logging to ``work_dir/log.jsonl``,
epoch checkpoints and validation every ``train_cfg.val_interval`` epochs, and
resumes exactly, also from the middle of an epoch. SIGTERM or SIGINT during
``train()`` saves ``preempt_step_N`` at the next step boundary and returns;
the previous handlers are back when ``train()`` returns. Each loader decodes
on the recipe's ``num_workers`` threads and prefetches ``prefetch`` batches
(2 unless the loader's block says otherwise). ``val()`` runs the val
pass: one forward a batch, the E/F/S/MAE statistics computed on the model's
device (``metrics/device.py``) and the full maps only for host-only metrics
or visualizations.

Under data parallelism (``parallel/dist.py``; ``torchrun --nproc_per_node=N
-m dgtd_tpu_torch.train``) the recipe's ``batch_size`` is the global batch:
each rank loads its rows of it and the train step averages the gradients.
Under a data×space layout (``-o dist.space=N``) the rows are the rank's
data row's: every rank of a space group loads the same rows, and the
train step bands them (``models/cod.py``). A checkpoint is whole on every
rank, so a run resumes under any layout.
Rank 0 writes the files (``log.jsonl``, checkpoints, visualizations, the
visualization backends' files, ``ProfilerHook``'s trace), and every rank
waits for a checkpoint to be written before it goes on. A signal stops
every rank at the same step boundary: the ranks agree on the stop flag
there. Every rank walks the whole val set in order (the ``parity``
reduction depends on the order) and the ranks' results are averaged, as
the JAX package's multi-host val pass does. Under a data×space layout
(``-m val -o dist.space=N``, ``parallel/space.py``) each rank runs its rows
and band of every val batch and the probability is gathered whole before
the metrics, so every rank scores the same maps.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from contextlib import closing
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.registry import DATASETS, HOOKS, METRICS, MODELS
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.device_norm import IMAGENET_MEAN, IMAGENET_STD, normalize_image, scale_plane
from ..data.loader import DataLoader
from ..metrics import evaluators as _evaluators  # noqa: F401  (registers the metrics)
from ..metrics.device import batch_statistics, statistics_to_host
from ..parallel import dist as pdist
from ..parallel import space
from .. import models as _models  # noqa: F401  (registers the models)
from ..convert import is_dead_key
from ..predict import load_checkpoint
from ..utils.visualizer import build_visualizer
from . import hooks as _hooks  # noqa: F401  (registers the hooks)
from .optim import Optimizer
from .state import train_step

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _loader(cfg: dict, train: bool, seed: int, device: torch.device, rank: int = 0, world: int = 1) -> DataLoader:
    """A loader block's loader: shuffled and without a ragged last batch
    when it trains, this rank's rows of each global batch; in order, every
    image, when it validates (the parity reduction depends on the order).
    ``num_workers`` decode threads and ``prefetch`` batches ahead, as the
    block says."""
    sampler = cfg.get("sampler", {}) or {}
    return DataLoader(
        DATASETS.build(cfg["dataset"]), int(cfg.get("batch_size", 1)),
        shuffle=bool(sampler.get("shuffle", train)), seed=seed, drop_last=train, device=device,
        num_workers=int(cfg.get("num_workers", 0)), prefetch=int(cfg.get("prefetch", 2)), rank=rank, world=world,
    )


def _host_plane(x) -> np.ndarray:
    """A label or depth batch on the host as float32 in [0, 1]."""
    a = _host(x)
    return a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a


class Runner:
    def __init__(self, cfg: dict, work_dir: str = "./output/run", seed: int = 0,
                 device: Optional[torch.device] = None, dtype: torch.dtype = torch.bfloat16,
                 mode: str = "train"):
        if mode not in ("train", "val"):
            raise ValueError(f"mode must be 'train' or 'val', got {mode!r}")
        self.cfg = cfg
        self.work_dir = work_dir
        self.seed = seed
        self.device = torch.device("cuda") if device is None else torch.device(device)
        self.rank, self.world, self.is_main = pdist.rank(), pdist.world(), pdist.is_main()
        tc = cfg.get("train_cfg", {}) or {}
        self.max_epochs = int(tc.get("max_epochs", 1))
        self.val_interval = int(tc.get("val_interval", self.max_epochs))
        loader_cfg = cfg.get("train_dataloader") or {}
        self.batch_size = int(loader_cfg.get("batch_size", 1))
        # a val-only run needs no train data
        self.train_loader = None
        if mode == "train":
            if "dataset" not in loader_cfg:
                raise ValueError("the recipe has no train_dataloader.dataset")
            layout = space.current()
            rows = (self.rank, self.world) if layout is None else (layout.data_index, layout.data)
            self.train_loader = _loader(loader_cfg, True, seed, self.device, *rows)
        # built now when training will validate, so that a missing val folder
        # fails before the first step; a recipe with no val data trains
        # without; otherwise built by the first val()
        has_val = "dataset" in (cfg.get("val_dataloader") or {})
        self.val_loader = None
        if mode == "val" or (has_val and 0 < self.val_interval <= self.max_epochs):
            self.val_loader = self._build_val_loader()
        self.steps_per_epoch = max(len(self.train_loader), 1) if self.train_loader else 1

        self.model = MODELS.build(dict(cfg["model"]), dtype=dtype, seed=seed).to(self.device)
        self.optimizer = Optimizer(self.model.named_parameters(), cfg.get("optim_wrapper", {}) or {},
                                   self.max_epochs, self.steps_per_epoch,
                                   frozen_prefixes=self.model.frozen_param_prefixes, model_cfg=cfg["model"])
        self.hooks = [HOOKS.build(h) for h in (cfg.get("default_hooks") or {}).values()]
        self.hooks += [HOOKS.build(h) for h in cfg.get("custom_hooks") or []]
        self.hooks.sort(key=lambda h: h.priority)
        self.metrics = [METRICS.build(m) for m in cfg.get("val_evaluator") or []]

        self.epoch = 0
        #: train steps taken, the step count of the lr schedule and of the
        #: DropPath generators
        self.host_step = 0
        self.resumed = False
        self._resume_skip = 0
        os.makedirs(work_dir, exist_ok=True)
        self._log_path = os.path.join(work_dir, "log.jsonl")
        self.vis_backends = build_visualizer(cfg.get("visualizer"), work_dir) if self.is_main else []
        if pdist.started():
            self.log({"dist": {"backend": dist.get_backend(), "world": self.world}})

    def _build_val_loader(self) -> DataLoader:
        loader_cfg = self.cfg.get("val_dataloader") or {}
        if "dataset" not in loader_cfg:
            raise ValueError("the recipe has no val_dataloader.dataset")
        return _loader(loader_cfg, False, self.seed, self.device)

    def log(self, record: Dict[str, Any]) -> None:
        """Print the record and append it to ``log.jsonl`` and the
        visualization backends (rank 0 only)."""
        if not self.is_main:
            return
        line = json.dumps(record)
        print(line, flush=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")
        if self.vis_backends and "step" in record:
            scalars = {k: v for k, v in record.items() if isinstance(v, (int, float))}
            for b in self.vis_backends:
                b.add_scalars(scalars, int(record["step"]))

    def save_checkpoint(self, name: str) -> str:
        """``work_dir/<name>.pth`` in MMEngine's layout: ``state_dict`` (the
        reference's key schema), ``optimizer``, ``meta`` (epoch, iter).
        Rank 0 writes it; every rank returns once it is written."""
        path = os.path.abspath(os.path.join(self.work_dir, f"{name}.pth"))
        if self.is_main:
            torch.save({
                "state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "meta": {"epoch": self.epoch, "iter": self.host_step},
            }, path)
            self.log({"checkpoint": path})
        pdist.barrier()
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Load model weights and BatchNorm statistics (not the optimizer):
        a ``.pth`` state_dict (the port's ``epoch_N.pth``, or a reference
        one) or a JAX flat ``.npz`` (``convert_ckpt full``'s, or the JAX
        trainer's), as ``predict.load_checkpoint`` reads them. Only the
        dead-module keys may go unmatched; a checkpoint that loads no
        parameter raises."""
        loaded, missed, unused = load_checkpoint(self.model, path)
        params = {n for n, _ in self.model.named_parameters()}
        if not params.intersection(loaded):
            raise ValueError(f"restore_checkpoint: no array of {path} matches a parameter of the model; "
                             "wrong checkpoint for this model or config?")
        unmatched = sorted(k for k in missed + unused if not is_dead_key(k))
        if unmatched:
            raise ValueError(f"restore_checkpoint: {len(unmatched)} keys of {path} and the model do not pair "
                             f"(first: {unmatched[:5]})")
        self.log({"restored": path, "loaded": len(loaded)})

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
        if self.train_loader is not None:
            self.train_loader.epoch = self.epoch
        self.resumed = True
        self.log({"resumed_at_epoch": self.epoch, "step": self.host_step, "skip_batches": self._resume_skip})

    def _install_preemption_handler(self) -> Dict[int, Any]:
        """SIGTERM and SIGINT request a checkpoint at the next step boundary
        (main thread only: a signal handler cannot be set elsewhere).
        Returns the handlers they replace."""
        self._stop_requested = False
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            self._stop_requested = True

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}

    def train(self) -> Dict[str, Any]:
        """Run the epochs left; returns {"steps", "loop_s"}: the steps this
        call took and the seconds from the first hook to the last, and
        "preempted" (the checkpoint's path) when a signal ended the run."""
        if self.train_loader is None:
            raise ValueError("a val-only Runner (mode='val') has no train loader")
        t0, first = time.perf_counter(), self.host_step
        previous = self._install_preemption_handler()
        try:
            for h in self.hooks:
                h.before_train(self)
            preempted = self._epochs()
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
            for h in self.hooks:
                h.after_train(self)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {"steps": self.host_step - first, "loop_s": time.perf_counter() - t0}
        if preempted:
            out["preempted"] = preempted
        return out

    def _epochs(self) -> Optional[str]:
        """The epoch loop; returns the preemption checkpoint's path if a
        signal ended it, else None. The loader's iterator is closed on every
        way out of an epoch, so its prefetch thread never outlives it."""
        while self.epoch < self.max_epochs:
            self.epoch += 1
            for h in self.hooks:
                h.before_train_epoch(self)
            skip, self._resume_skip = self._resume_skip, 0
            with closing(iter(self.train_loader)) as batches:
                for i, batch in enumerate(batches):
                    if i < skip:
                        continue
                    arrays = {k: batch[k] for k in ("input", "label", "depth")}
                    aux = train_step(self.model, self.optimizer, arrays, self.host_step, self.seed + 1)
                    self.host_step += 1
                    for h in self.hooks:
                        h.after_train_iter(self, aux)
                    if pdist.any_rank(self._stop_requested):
                        path = self.save_checkpoint(f"preempt_step_{self.host_step}")
                        self.log({"preempted": True, "checkpoint": path})
                        return path
            for h in self.hooks:
                h.after_train_epoch(self)
            if self.val_loader is not None and self.val_interval and self.epoch % self.val_interval == 0:
                self.val(during_train=True)
        return None

    # ---------------------------------------------------------------- val

    def _predict(self, image: torch.Tensor, depth: torch.Tensor):
        """The eval forward on a batch as the loader gives it: (prob
        (B,H,W,1) fp32, extras with the texture); under a data×space layout
        both gathered whole from the ranks' rows and bands."""
        prob, extras = self.model.predict(normalize_image(image), scale_plane(depth))
        if space.current() is not None:
            h = image.shape[1]
            prob = space.gather_map(prob, h)
            if extras.get("texture") is not None:
                extras = {**extras, "texture": space.gather_map(extras["texture"], self.model.texture_height(h))}
        return prob, extras

    def val(self, during_train: bool = False, save_visualizations: bool = False) -> Dict[str, float]:
        """One pass over the val loader; logs {"epoch", "step", the metrics
        rounded to 5 places, "val_imgs_per_sec"} and returns the metrics
        unrounded. Hooks' ``before_val`` fires unless ``during_train``.

        Each batch takes one forward. The evaluators that consume per-image
        statistics get them from ``batch_statistics`` on the model's device,
        copied to the host once a batch; the others (e.g. WeightedFmeasure)
        get the probability map on the host from the same forward. With
        ``device_metrics: false`` in the recipe, or ``save_visualizations``,
        every metric takes the map on the host."""
        if not during_train:
            for h in self.hooks:
                h.before_val(self)
        if self.val_loader is None:
            self.val_loader = self._build_val_loader()
        for m in self.metrics:
            m.reset()
        self._vis_counter = -1
        vis_dir = os.path.join(self.work_dir, "visualizations")
        device_ok = bool(self.cfg.get("device_metrics", True)) and not save_visualizations
        stats_metrics = [m for m in self.metrics if device_ok and getattr(m, "supports_device_stats", False)]
        host_metrics = [m for m in self.metrics if m not in stats_metrics]
        n_images = 0
        t0 = time.perf_counter()
        with closing(iter(self.val_loader)) as batches:
            for batch in batches:
                prob, extras = self._predict(batch["input"], batch["depth"])
                n_images += prob.shape[0]
                if stats_metrics:
                    stats = statistics_to_host(batch_statistics(prob, scale_plane(batch["label"])))
                    for m in stats_metrics:
                        m.process_stats(stats)
                if host_metrics or save_visualizations:
                    prob_np, label_np = _host(prob), _host_plane(batch["label"])
                    for m in host_metrics:
                        m.process(prob_np, label_np)
                    if save_visualizations and self.is_main:
                        self._dump_visualizations(vis_dir, batch, prob_np, extras)
        results: Dict[str, float] = {}
        for m in self.metrics:
            results.update(m.compute())
        results = pdist.all_mean(results)
        results["val_imgs_per_sec"] = n_images / max(time.perf_counter() - t0, 1e-9)
        self.log({"epoch": self.epoch, "step": self.host_step, **{k: round(v, 5) for k, v in results.items()}})
        return results

    def _dump_visualizations(self, vis_dir: str, batch, prob_np: np.ndarray, extras=None) -> None:
        """``<name>_{input,label,output,depth,diffusion}.png`` per image, from
        the forward that gave ``prob_np``: the denormalized input, the label,
        the probability map, the depth and the contrast-enhanced texture (no
        ``_diffusion.png`` when the model returns no texture). ``name`` is the
        file's stem when ``raw`` is a path, else a running ``img{n}``."""
        from PIL import Image

        os.makedirs(vis_dir, exist_ok=True)

        def save(name, arr):  # (H, W) or (H, W, 3) in [0, 1]
            Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(os.path.join(vis_dir, name))

        input_np = _host(batch["input"])
        if input_np.dtype == np.uint8:  # to the normalized form denormalized below
            input_np = (input_np.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        label_np, depth_np = _host_plane(batch["label"]), _host_plane(batch["depth"])
        tex = extras.get("texture") if extras else None
        texture_np = None if tex is None else _host(tex.float())
        raws = batch.get("raw")
        for i in range(prob_np.shape[0]):
            if isinstance(raws, list) and isinstance(raws[i], str):
                name = os.path.splitext(os.path.basename(raws[i]))[0]
            else:
                self._vis_counter += 1
                name = f"img{self._vis_counter}"
            save(f"{name}_output.png", prob_np[i, ..., 0])
            save(f"{name}_label.png", label_np[i, ..., 0])
            save(f"{name}_input.png", input_np[i] * IMAGENET_STD + IMAGENET_MEAN)
            save(f"{name}_depth.png", depth_np[i, ..., 0])
            if texture_np is not None:
                # contrast-enhanced as the reference does (cod.py:194-204)
                t = texture_np[i].mean(axis=-1)
                t = np.clip((t - t.mean()) * 2.0 + t.mean(), 0, 1)
                save(f"{name}_diffusion.png", t)
