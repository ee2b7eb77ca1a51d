"""Run the reference PyTorch model on the CPU as a numerical oracle (the
port's own copy of the parts of ``dgtd_tpu/tools/ref_oracle.py`` that
``tools/metric_parity.py`` uses).

The reference (``<root>/twig/model/cod.py``, the root as
:func:`reference_root` says) imports a stack of training packages (mmengine,
nest, timm, segment_anything, torchcam, torchvision, mmseg) of which its
models' ``__init__`` and forward use a handful of symbols. This module
installs minimal stubs for those, imports a reference file from its path,
and keeps the reference's hard-coded ``.cuda()`` calls (``cod.py:1259``
allocates its FFT mask on CUDA even in a CPU run) on the CPU while the
reference runs (:func:`cpu_cuda_calls`), so that the rest of the process
keeps ``Tensor.cuda``.

The reference is not part of the repository; without it the loaders raise
``FileNotFoundError`` naming the path they looked for.
"""

from __future__ import annotations

import contextlib
import importlib.machinery
import importlib.util
import os
import sys
import types
from typing import Any, Dict


def reference_root() -> str:
    """``$DGTD_REFERENCE_ROOT``, else ``~/reference`` (the checkout that
    ``dgtd_tpu/tools/ref_oracle.py`` names by its absolute path)."""
    return os.environ.get("DGTD_REFERENCE_ROOT", os.path.join(os.path.expanduser("~"), "reference"))


def reference_cod_path() -> str:
    return os.path.join(reference_root(), "twig", "model", "cod.py")


def reference_available() -> bool:
    return os.path.exists(reference_cod_path())


def _mod(name: str) -> types.ModuleType:
    m = types.ModuleType(name)
    # a real ModuleSpec, so that importlib.util.find_spec probes see a
    # well-formed module
    m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
    sys.modules[name] = m
    return m


def install_stubs() -> None:
    """Register import stubs for the reference's unused heavy dependencies."""
    if "nest" in sys.modules and hasattr(sys.modules["nest"], "export"):
        return

    import torch
    import torch.nn as nn

    nest = _mod("nest")
    nest.export = lambda obj: obj  # @export is a registry decorator

    mmengine = _mod("mmengine")
    mm_model = _mod("mmengine.model")
    mm_model.BaseModel = nn.Module  # the reference only calls super().__init__()
    mm_model.MMDistributedDataParallel = type("MMDistributedDataParallel", (), {})
    mm_hooks = _mod("mmengine.hooks")
    mm_hooks.Hook = object
    mm_eval = _mod("mmengine.evaluator")

    class BaseMetric:  # enough surface for twig/metric/*.py
        def __init__(self, collect_device="cpu", prefix=None, **kwargs):
            self.collect_device = collect_device
            self.prefix = prefix
            self.results = []

    mm_eval.BaseMetric = BaseMetric
    mmengine.model = mm_model
    mmengine.hooks = mm_hooks
    mmengine.evaluator = mm_eval

    timm = _mod("timm")
    timm_models = _mod("timm.models")
    timm_resnet = _mod("timm.models.resnet")
    timm_resnet.Bottleneck = object  # imported, never instantiated
    timm_layers = _mod("timm.models.layers")

    class DropPath(nn.Module):
        """Per-sample stochastic depth (timm's); the identity in eval."""

        def __init__(self, drop_prob: float = 0.0):
            super().__init__()
            self.drop_prob = drop_prob

        def forward(self, x):
            if self.drop_prob == 0.0 or not self.training:
                return x
            keep = 1.0 - self.drop_prob
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            mask = torch.floor(keep + torch.rand(shape, dtype=x.dtype, device=x.device))
            return x / keep * mask

    def to_2tuple(v):
        return v if isinstance(v, tuple) else (v, v)

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        with torch.no_grad():
            tensor.normal_(mean, std).clamp_(min=a * std + mean, max=b * std + mean)
        return tensor

    timm_layers.DropPath = DropPath
    timm_layers.to_2tuple = to_2tuple
    timm_layers.trunc_normal_ = trunc_normal_
    timm_registry = _mod("timm.models.registry")
    timm_registry.register_model = lambda fn: fn
    timm_vit = _mod("timm.models.vision_transformer")
    timm_vit._cfg = lambda url="", **kwargs: {"url": url, **kwargs}
    timm.models = timm_models
    timm.create_model = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("timm.create_model stub: not used by the oracle path")
    )
    timm_models.resnet = timm_resnet
    timm_models.layers = timm_layers
    timm_models.registry = timm_registry
    timm_models.vision_transformer = timm_vit

    sam = _mod("segment_anything")
    sam.sam_model_registry = {}
    sam_utils = _mod("segment_anything.utils")
    sam_transforms = _mod("segment_anything.utils.transforms")
    sam_transforms.ResizeLongestSide = object
    sam.utils = sam_utils
    sam_utils.transforms = sam_transforms

    torchcam = _mod("torchcam")
    torchcam_methods = _mod("torchcam.methods")
    torchcam_methods.CAM = object
    torchcam.methods = torchcam_methods

    torchvision = _mod("torchvision")
    tv_transforms = _mod("torchvision.transforms")
    tv_utils = _mod("torchvision.utils")
    tv_utils.save_image = lambda *a, **k: None
    torchvision.transforms = tv_transforms
    torchvision.utils = tv_utils

    _mod("mmseg")


@contextlib.contextmanager
def cpu_cuda_calls():
    """While the reference runs, ``Tensor.cuda`` returns the tensor where it
    is (the reference calls ``.cuda()`` inside its forward, cod.py:1259,
    :206-207)."""
    import torch

    saved = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        yield
    finally:
        torch.Tensor.cuda = saved


_loaded: Dict[str, Any] = {}


def load_reference_module(relpath: str) -> Any:
    """Import a reference ``.py`` file (a path under the reference root)
    with the stubs installed; raises ``FileNotFoundError`` naming the path
    when it is not there."""
    path = os.path.join(reference_root(), relpath)
    if path in _loaded:
        return _loaded[path]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    install_stubs()
    name = "dgtd_torch_reference_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    with cpu_cuda_calls():
        spec.loader.exec_module(module)
    _loaded[path] = module
    return module


def load_reference_cod() -> Any:
    """The reference's ``twig/model/cod.py``, imported with the stubs."""
    return load_reference_module(os.path.join("twig", "model", "cod.py"))
