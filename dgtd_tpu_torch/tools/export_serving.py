"""Serving bundles: a model's predict exported once per resolution with
``torch.export``, the weights beside it (counterpart of
``dgtd_tpu/tools/export_serving.py``).

A bundle serves without the model code, the registry or the config loader:
``ServingModel.load`` needs torch, numpy and this package's ``ops`` (which
register the kernels' custom ops that the programs call).

    bundle/
      meta.json                       format_version, sizes, platforms,
                                      artifacts, model, ckpt, loaded_params
      params.npz                      float32 state dict in the port's keys
                                      (the reference's ``hitnet.*`` schema),
                                      once a bundle
      predict_<S>_<platform>.pt2      a ``torch.export`` program per size
                                      and platform (cuda, cpu)

A program takes the weights as an input, as the JAX program takes its
variables: ``program(params, image, depth) -> prob`` with image
(1, S, S, 3) and depth (1, S, S, 1) float32 NHWC and prob (1, S, S, 1), so
no weight is stored in a ``.pt2``. Compute is bf16 autocast unless
``--fp32``; the diffusion stencil (and, in a program that holds one, the
MSDA forward) runs as the ``dgtd_torch::`` custom ops, on CUDA the
hand-written kernels. ``ServingModel`` sends an image to the smallest size
at least as large as its longer side (else the largest) and resizes to it
and back as ``jax.image.resize(..., "bilinear")`` does, antialiasing when
it shrinks.

    python -m dgtd_tpu_torch.tools.export_serving --config configs/cod.yml \\
        --ckpt epoch_100.pth --sizes 384 704 --out bundle/ [--platforms cuda cpu] [--fp32]

``--ckpt`` takes a port or reference ``.pth`` or a JAX flat ``.npz``
(carried across by ``convert.state_dict_from_flax``) and loads strictly:
only BatchNorm's step counters and the reference's dead modules may go
unmatched. The default platform is cuda (a missing card raises).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import ops as _ops  # noqa: F401  (registers the dgtd_torch:: custom ops)
from ..core.device import resolve_device

FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")


def serving_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The weights a program takes: every floating-point entry of the
    model's state dict as float32 on the CPU (BatchNorm's integer step
    counters are bookkeeping, not weights)."""
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items() if v.is_floating_point()}


class _Served(torch.nn.Module):
    """``model.predict``'s probability map as a module's forward, the
    model its one submodule (so the weights' keys gain a ``model.``)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image, depth):
        return self.model.predict(image, depth)[0]


class _Program(torch.nn.Module):
    """What is exported: ``(params, image, depth) -> prob``, the weights an
    input. The model is held outside the module tree, so that export lifts
    none of its weights into the program."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.__dict__["served"] = _Served(model)

    def forward(self, params: Dict[str, torch.Tensor], image, depth):
        weights = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.served, weights, (image, depth), strict=False)


def _drop_dtype_asserts(exported) -> None:
    """Remove the dtype checks that ``torch.export`` records before each
    ``.to``. It traces an autocast region without autocast's casts (the
    region is replayed under autocast when the program runs), so an op that
    autocast runs in fp32 (``upsample_bilinear2d`` on CUDA) is traced in
    bf16, and the check fails on the run's fp32. The ``.to`` after each
    check stays in the graph and casts as the eager forward does."""
    check = torch.ops.aten._assert_tensor_metadata.default
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in list(module.graph.nodes):
                if node.op == "call_function" and node.target is check:
                    module.graph.erase_node(node)
            module.recompile()


def export_bundle(model: torch.nn.Module, out_dir: str, sizes: Sequence[int] = (384,),
                  platforms: Optional[Sequence[str]] = None, meta_extra: Optional[dict] = None) -> dict:
    """Write a serving bundle of ``model`` (a registered model, its compute
    dtype set when it was built) to ``out_dir``. ``platforms`` (default
    ``("cuda",)``) lists the devices to export for; each program runs on its
    own. Returns the meta, with the seconds each export took."""
    platforms = list(platforms) if platforms else ["cuda"]
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}: {PLATFORMS}")
        resolve_device(platform)
    os.makedirs(out_dir, exist_ok=True)
    was_training = model.training
    home = next(model.parameters()).device
    params = serving_params(model)
    sizes = sorted(int(s) for s in sizes)
    artifacts: Dict[str, Dict[str, str]] = {str(s): {} for s in sizes}
    seconds: Dict[str, Dict[str, float]] = {p: {} for p in platforms}
    model.eval()
    try:
        for platform in platforms:
            dev = torch.device(platform)
            model.to(dev)
            on_dev = {k: v.to(dev) for k, v in params.items()}
            program = _Program(model)
            for s in sizes:
                image = torch.zeros((1, s, s, 3), device=dev)
                depth = torch.zeros((1, s, s, 1), device=dev)
                t0 = time.perf_counter()
                exported = torch.export.export(program, (on_dev, image, depth))
                _drop_dtype_asserts(exported)
                exported.example_inputs = None  # else the .pt2 keeps the weights it was traced with
                name = f"predict_{s}_{platform}.pt2"
                torch.export.save(exported, os.path.join(out_dir, name))
                seconds[platform][str(s)] = time.perf_counter() - t0
                artifacts[str(s)][platform] = name
            del on_dev
    finally:
        model.to(home)
        model.train(was_training)
    np.savez(os.path.join(out_dir, "params.npz"), **{k: v.numpy() for k, v in params.items()})
    meta = {
        "format_version": FORMAT_VERSION,
        "sizes": sizes,
        "platforms": platforms,
        "artifacts": artifacts,
        "compute": str(getattr(model, "dtype", torch.float32)).replace("torch.", ""),
        **(meta_extra or {}),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return {**meta, "export_seconds": seconds}


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s linear kernel along
    one axis (``jax._src.image.scale.compute_weight_mat``): half-pixel
    centres, the triangle widened by the shrink factor when shrinking
    (antialias), each column normalised, columns whose sample lies outside
    the input zero; in float32 as JAX computes them."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def _resize_nhwc(x: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of an NHWC float32 array to ``size`` (an int for a
    square, or (H, W)) as ``jax.image.resize(x, ..., "bilinear")``: an axis
    whose size does not change is left as it is."""
    h, w = (size, size) if isinstance(size, int) else tuple(size)
    out = np.asarray(x, np.float32)
    if out.shape[1] != h:
        out = np.einsum("nhwc,hH->nHwc", out, _resize_weights(out.shape[1], h))
    if out.shape[2] != w:
        out = np.einsum("nhwc,wW->nhWc", out, _resize_weights(out.shape[2], w))
    return np.ascontiguousarray(out, np.float32)


class ServingModel:
    """Run a bundle: ``ServingModel.load(dir)(image, depth)``."""

    def __init__(self, meta: dict, params: Dict[str, torch.Tensor], programs: Dict[int, Any],
                 device: torch.device):
        self.meta = meta
        self.params = params
        self.programs = programs
        self.device = device
        self.sizes = sorted(programs)

    @classmethod
    def load(cls, path: str, device=None) -> "ServingModel":
        """Load the bundle's weights and its programs for ``device`` (default
        cuda; a missing card raises, as does a bundle without programs for
        the device's platform or of a newer format)."""
        device = resolve_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(f"bundle format {meta['format_version']} is newer than this loader")
        if device.type not in meta["platforms"]:
            raise ValueError(f"bundle {path} has programs for {meta['platforms']}, not {device.type}")
        with np.load(os.path.join(path, "params.npz")) as z:
            params = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
        programs = {int(s): torch.export.load(os.path.join(path, names[device.type])).module()
                    for s, names in meta["artifacts"].items()}
        return cls(meta, params, programs, device)

    def _bucket(self, h: int, w: int) -> int:
        side = max(h, w)
        for s in self.sizes:
            if s >= side:
                return s
        return self.sizes[-1]

    def run(self, size: int, image: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """The program of ``size`` on tensors already on the device."""
        with torch.inference_mode():
            return self.programs[size](self.params, image, depth)

    def __call__(self, image: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """image (1,H,W,3), depth (1,H,W,1) float32 -> prob (1,H,W,1)."""
        h, w = image.shape[1:3]
        s = self._bucket(h, w)
        if (h, w) != (s, s):
            image = _resize_nhwc(image, s)
            depth = _resize_nhwc(depth, s)
        prob = self.run(s, torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device),
                        torch.from_numpy(np.ascontiguousarray(depth, np.float32)).to(self.device))
        prob = prob.float().cpu().numpy()
        if (h, w) != (s, s):
            prob = _resize_nhwc(prob, (h, w))
        return prob


def load_checkpoint_strict(model: torch.nn.Module, path: str) -> int:
    """Load ``path`` (a ``.pth`` state dict, a reference ``epoch_N.pth`` or
    a JAX flat ``.npz``) into ``model`` strictly: a weight the checkpoint
    lacks or a key the model lacks raises, except BatchNorm's step counters
    and the reference's dead modules. Returns the keys loaded."""
    from ..predict import read_checkpoint
    from ..convert import is_dead_key

    state = read_checkpoint(path)
    result = model.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys if not is_dead_key(k)]
    unexpected = [k for k in result.unexpected_keys if not is_dead_key(k)]
    if missing or unexpected:
        raise ValueError(f"checkpoint {path} and the model do not pair: {len(missing)} weights missing (first: "
                         f"{missing[:5]}), {len(unexpected)} keys unused (first: {unexpected[:5]})")
    unused = set(result.unexpected_keys)
    return sum(k not in unused for k in state)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", help="recipe YAML; its model: block selects the network")
    ap.add_argument("--model", default=None, help="registered model name (overrides config)")
    ap.add_argument("--ckpt", default=None, help="checkpoint: .pth (port or reference) or JAX flat .npz")
    ap.add_argument("--sizes", type=int, nargs="+", default=[384])
    ap.add_argument("--platforms", nargs="*", default=None, help="cuda and/or cpu (default: cuda)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--fp32", action="store_true", help="export fp32 compute (default bf16)")
    args = ap.parse_args(argv)

    from .. import models as _models  # noqa: F401  (registers the models)
    from ..core.registry import MODELS

    model_cfg: Dict[str, Any] = {"type": "cod"}
    if args.config:
        from ..core.config import load_config

        model_cfg = dict(load_config(args.config, []).get("model") or model_cfg)
    if args.model:
        model_cfg["type"] = args.model
    model = MODELS.build(model_cfg, dtype=torch.float32 if args.fp32 else torch.bfloat16, seed=0)
    loaded = load_checkpoint_strict(model, args.ckpt) if args.ckpt else 0
    meta = export_bundle(model, args.out, sizes=args.sizes, platforms=args.platforms,
                         meta_extra={"model": model_cfg["type"], "ckpt": args.ckpt, "loaded_params": loaded})
    print(json.dumps({"exported": args.out, **meta}), flush=True)
    return meta


if __name__ == "__main__":
    main()
