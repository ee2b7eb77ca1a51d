"""The system under test, as the benchmark drives it: the only module here
that imports ``dgtd_tpu_torch``.

It builds a configuration's model through the port's ``MODELS`` registry
(on the meta device, then empty on the card, then ``load_state_dict`` of
the benchmark's seeded weights: the port's own initializer does not run),
its optimizer (``train/optim.py::Optimizer`` from the configuration's
``optim_wrapper``), and the timed calls: ``train/state.py::train_step`` on
a uint8 batch copied from pinned host memory, and ``predict.py``'s served
sequence (the copy to the card, ``normalize_image`` and ``scale_plane``,
``SegModel.predict``, the fp32 map copied to the host).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dgtd_tpu_torch import models as _models  # noqa: F401  (registers the models)
from dgtd_tpu_torch.core.registry import MODELS
from dgtd_tpu_torch.data.device_norm import normalize_image, scale_plane
from dgtd_tpu_torch.train.optim import Optimizer
from dgtd_tpu_torch.train.state import train_step


def build_model(program: dict, state: Dict[str, torch.Tensor], device: torch.device):
    """The configuration's model on ``device`` holding ``state``."""
    with torch.device("meta"):
        model = MODELS.build(dict(program["model"]), dtype=getattr(torch, program["dtype"]), seed=None)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def build_optimizer(program: dict, model) -> Optimizer:
    sched = program["schedule"]
    return Optimizer(model.named_parameters(), program["optim_wrapper"], sched["max_epochs"], sched["steps_per_epoch"],
                     frozen_prefixes=model.frozen_param_prefixes, model_cfg=program["model"])


def first_moments(model, opt: Optimizer) -> Dict[str, torch.Tensor]:
    """AdamW's first moment of each parameter, by name (after a step)."""
    names = {p: n for n, p in model.named_parameters()}
    return {names[p]: st["exp_avg"] for p, st in opt.opt.state.items() if "exp_avg" in st}


def betas(opt: Optimizer) -> Tuple[float, float]:
    return tuple(opt.opt.param_groups[0]["betas"])


def train_call(model, opt: Optimizer, host_batch: Dict[str, torch.Tensor], step: int, seed: int, device):
    """One train step as the window drives it: the uint8 host batch copied
    to the card, then the port's ``train_step``; returns its loss terms
    (device scalars)."""
    batch = {k: v.to(device, non_blocking=True) for k, v in host_batch.items()}
    return train_step(model, opt, batch, step, seed)


def serve_call(model, host_batch: Dict[str, torch.Tensor], device):
    """One served batch as ``predict.py`` runs it, up to the map's copy to
    the host being enqueued: (host fp32 NHWC map, an event recorded after
    the copy, or None on the CPU)."""
    image = normalize_image(host_batch["input"].to(device, non_blocking=True))
    depth = scale_plane(host_batch["depth"].to(device, non_blocking=True))
    prob = model.predict(image, depth)[0]
    host = prob.to("cpu", non_blocking=True)
    done = None
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record()
    return host, done


def prompt_encoder(model):
    """The prompt encoder module of a model that has one, else None."""
    hitnet = getattr(model, "hitnet", None)
    backbone = getattr(hitnet, "backbone", None)
    return getattr(backbone, "prompt_encoder", None)

