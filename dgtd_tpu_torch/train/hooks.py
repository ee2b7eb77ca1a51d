"""Runner hooks: logging, checkpointing, a profiler trace of a window of
steps, the models' pretrained-weight init (``our_init``, ``baseline_init``,
``PretrainInitHook``) and the val checkpoint (counterpart of
``dgtd_tpu/train/hooks.py``). Under data parallelism rank 0 writes the
files: the log records, the checkpoints and the trace.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.registry import HOOKS


class Hook:
    priority = 50

    def before_train(self, runner):
        pass

    def before_train_epoch(self, runner):
        pass

    def after_train_iter(self, runner, metrics: Dict[str, Any]):
        pass

    def after_train_epoch(self, runner):
        pass

    def after_train(self, runner):
        """Fired once when training ends, also when it ends in an exception."""
        pass

    def before_val(self, runner):
        """Fired before a val pass that is not part of training (``-m val``)."""
        pass


@HOOKS.register
class LoggerHook(Hook):
    """Every ``interval`` steps one JSON record (step, epoch, images/s since
    the last record, the loss terms) to stdout and ``log.jsonl``. Unless
    ``ignore_last``, an epoch's last step is logged too."""

    def __init__(self, interval: int = 20, ignore_last: bool = False):
        self.interval = interval
        self.ignore_last = ignore_last
        self._t0 = None
        self._last_step = 0
        self._last_logged = -1
        self._pending = None

    def before_train_epoch(self, runner):
        # the window starts with the epoch: a checkpoint save between epochs
        # is not a slower step
        self._t0 = time.time()
        self._last_step = runner.host_step

    def _emit(self, runner, step, metrics):
        values = {k: round(float(v), 5) for k, v in metrics.items()}  # waits for the step
        now = time.time()
        ips = (step - self._last_step) * runner.batch_size / max(now - self._t0, 1e-9)
        self._t0, self._last_step, self._last_logged = now, step, step
        runner.log({"step": step, "epoch": runner.epoch, "imgs_per_sec": round(ips, 2), **values})

    def after_train_iter(self, runner, metrics):
        step = runner.host_step
        if step % self.interval == 0:
            self._emit(runner, step, metrics)
        else:
            self._pending = metrics

    def after_train_epoch(self, runner):
        step = runner.host_step
        if not self.ignore_last and step != self._last_logged and self._pending is not None:
            self._emit(runner, step, self._pending)
        self._pending = None


@HOOKS.register
class ProfilerHook(Hook):
    """A ``torch.profiler`` trace of train steps ``[start_step, start_step +
    num_steps)`` (0-based; CPU activity, and CUDA activity on a card) into
    ``work_dir/profile`` (or ``out_dir``) as a Chrome trace
    (``trace_steps_<first>-<end>.json``, for Perfetto or chrome://tracing).
    It starts at the first step boundary at or after ``start_step`` (a resumed
    run past it logs ``profile_started_late``) and synchronizes the device
    before it starts and before it stops; a trace still open when training
    ends (a preemption, an exception) is closed then and logged with
    ``truncated: true``. Under data parallelism rank 0 alone traces."""

    def __init__(self, start_step: int = 10, num_steps: int = 3, out_dir: Optional[str] = None):
        self.start_step = start_step
        self.num_steps = num_steps
        self.out_dir = out_dir
        self._prof = None
        self._done = False
        self._started_at = None

    @staticmethod
    def _sync(runner):
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)

    def after_train_iter(self, runner, metrics):
        if self._done or not runner.is_main:
            return
        step = runner.host_step
        if self._prof is None and step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if runner.device.type == "cuda" else [])
            self._sync(runner)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._started_at = step
            if step != self.start_step:
                runner.log({"profile_started_late": step, "configured": self.start_step})
        elif self._prof is not None and step >= self._started_at + self.num_steps:
            self._stop(runner, truncated=False)

    def _stop(self, runner, truncated: bool) -> None:
        self._sync(runner)
        self._prof.stop()
        out = self.out_dir or os.path.join(runner.work_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_steps_{self._started_at}-{runner.host_step}.json")
        self._prof.export_chrome_trace(path)
        self._prof, self._done = None, True
        rec = {"profile": path, "step": runner.host_step}
        if truncated:
            rec["truncated"] = True
        runner.log(rec)

    def after_train(self, runner):
        if self._prof is not None:
            self._stop(runner, truncated=True)


@HOOKS.register
class CheckpointHook(Hook):
    """``work_dir/epoch_N.pth`` every ``interval`` epochs; with ``max_keep``
    only the newest N are kept."""

    def __init__(self, interval: int = 10, by_epoch: bool = True, max_keep: Optional[int] = None):
        if not by_epoch:
            raise ValueError("CheckpointHook saves by epoch only (by_epoch: true)")
        self.interval = interval
        self.max_keep = max_keep
        self._saved = []

    def after_train_epoch(self, runner):
        if runner.epoch % self.interval == 0:
            self._saved.append(runner.save_checkpoint(f"epoch_{runner.epoch}"))
            while self.max_keep and len(self._saved) > self.max_keep:
                old = self._saved.pop(0)
                if runner.is_main and os.path.exists(old):
                    os.remove(old)
                runner.log({"checkpoint_evicted": old})


def _pretrain_state(path: str, port_prefix: str, jax_subtree: str) -> Dict[str, torch.Tensor]:
    """A pretrained tower's weights, keyed relative to ``port_prefix``: a
    ``.pth`` state_dict with keys relative to the tower (the official PVTv2
    and ConvNeXt files), or a ``.npz`` of the JAX package's converted tower
    (keys relative to ``jax_subtree``), carried across by the key table."""
    if path.endswith(".npz"):
        from ..convert import map_flax_key

        out = {}
        with np.load(path) as z:
            for k in z.files:
                key = k[len("params/"):] if k.startswith("params/") else k
                hit = map_flax_key(f"{jax_subtree}/{key}")
                if hit is not None and hit[0].startswith(port_prefix + "."):
                    out[hit[0][len(port_prefix) + 1:]] = torch.from_numpy(
                        np.array(hit[1](np.asarray(z[k], np.float32)), order="C"))
        return out
    state = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("model", "state_dict"):
        if isinstance(state, dict) and wrap in state:
            state = state[wrap]
    return state


class _PretrainInit(Hook):
    """The reference's init hooks: before training, load each pretrained
    tower named in ``towers`` (the hook's argument, the port's module, the
    JAX package's subtree); before a val pass, restore ``val_ckpt``
    (``Runner.restore_checkpoint``).

    With no paths it does nothing (the recipes name none). A named file that
    is missing, or that matches no parameter, raises: a val pass on a missing
    ``val_ckpt`` would score random weights. So does a tower the model does
    not have (a ``cod``-shaped hook on ``DQnet``). After a resume it loads
    no pretrain: the checkpoint already holds the fine-tuned weights."""

    priority = 40
    towers = (("backbone_ckpt", "hitnet.backbone", "hitnet/backbone"),
              ("convnext_ckpt", "hitnet.backbone.prompt_encoder.encoder2", "hitnet/prompt_encoder/encoder2"))

    def __init__(self, backbone_ckpt: Optional[str] = None, convnext_ckpt: Optional[str] = None,
                 val_ckpt: Optional[str] = None):
        self.backbone_ckpt = backbone_ckpt
        self.convnext_ckpt = convnext_ckpt
        self.val_ckpt = val_ckpt

    def before_train(self, runner):
        name = type(self).__name__
        if runner.resumed:
            runner.log({"hook": name, "skip_pretrains": "resumed"})
            return
        for attr, port_prefix, jax_subtree in self.towers:
            path = getattr(self, attr)
            if path:
                self._load(runner, path, port_prefix, jax_subtree)

    def before_val(self, runner):
        if not self.val_ckpt:
            return
        if not os.path.exists(self.val_ckpt):
            raise FileNotFoundError(f"{type(self).__name__}: val_ckpt {self.val_ckpt} does not exist")
        runner.restore_checkpoint(self.val_ckpt)

    def _load(self, runner, path, port_prefix, jax_subtree):
        name = type(self).__name__
        if not os.path.exists(path):
            raise FileNotFoundError(f"{name}: {path} does not exist")
        try:
            module = runner.model.get_submodule(port_prefix)
        except AttributeError:
            raise ValueError(f"{name}: the model ({type(runner.model).__name__}) has no module '{port_prefix}' "
                             "— wrong init hook for this model? (DQnet takes PretrainInitHook)") from None
        state = _pretrain_state(path, port_prefix, jax_subtree)
        own = module.state_dict()
        matched = {k: v for k, v in state.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
        if not matched:
            raise ValueError(
                f"{name}: 0 of {len(state)} arrays from {path} match a parameter of {port_prefix}"
                " — wrong checkpoint for this tower?"
            )
        module.load_state_dict(matched, strict=False)
        runner.log({"hook": name, "loaded": len(matched), "from": path, "into": port_prefix})


@HOOKS.register
class our_init(_PretrainInit):
    """The ``cod`` init hook: a pretrained PVTv2 into ``hitnet.backbone``, a
    ConvNeXt into the prompt encoder's tower."""


@HOOKS.register
class baseline_init(_PretrainInit):
    """The ``baseline`` init hook: the same towers as ``our_init``."""


@HOOKS.register
class PretrainInitHook(_PretrainInit):
    """The ``DQnet`` init hook: a pretrained PVTv2 into the top-level
    ``backbone``. DQnet has no ConvNeXt tower, so ``convnext_ckpt`` raises."""

    towers = (("backbone_ckpt", "backbone", "backbone"),)

    def __init__(self, backbone_ckpt: Optional[str] = None, convnext_ckpt: Optional[str] = None,
                 val_ckpt: Optional[str] = None):
        if convnext_ckpt:
            raise ValueError("PretrainInitHook: DQnet has no ConvNeXt tower to load convnext_ckpt into")
        super().__init__(backbone_ckpt, None, val_ckpt)
