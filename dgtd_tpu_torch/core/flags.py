"""Run-time switches (counterpart of ``dgtd_tpu/core/flags.py``).

Plain module-level values, read when a model runs, not when it is built:
flip them with :func:`set_flag` (an unknown name raises ``AttributeError``).

``diffusion_plane_layout`` picks the diffusion stencil's layout in
``models/diffusion.py::MessagePassing``. The JAX package's ``None`` is
automatic (Pallas planes on a TPU at grids of 64 or more, fused XLA in NHWC
otherwise) and ``True``/``False`` force a layout. The port never sends a
CUDA tensor to a plain version, so here the flag picks between two kernel
families: ``None`` and ``True`` the plane layout (``ops/diffusion.py::
diffusion_planes``: the fused, cluster, tiled or per-step plane kernels),
``False`` the NHWC layout (``ops/diffusion.py::diffusion_nhwc``: the NHWC
plane, grid or per-step forward, the plane backward on NHWC gradients). On
the CPU both run their plain versions, which agree within float rounding.

``debug_nans`` is ``jax_debug_nans``'s counterpart. JAX raises
``FloatingPointError`` at the first primitive that makes a NaN, in the
forward or the backward. PyTorch has no such switch, so ``True`` installs
two checks: a global module forward hook that raises
``FloatingPointError`` naming the module (its class and its
``extra_repr``, e.g. ``Conv2d(24, 3, kernel_size=(1, 1), stride=(1, 1))``)
whose output holds a NaN or an infinity, and ``torch.autograd.set_detect_anomaly(True, check_nan=True)``,
under which a backward function that returns a NaN raises
``RuntimeError`` naming that function. The forward check sees module
outputs only, not each operation inside a module's forward; both cost host
time on every call (the hook synchronises with the device to read each
output). ``False`` removes the hook and turns anomaly mode off again.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

#: the diffusion stencil's layout: None (automatic) and True the plane
#: layout, False the NHWC layout
diffusion_plane_layout: Optional[bool] = None

#: raise on a NaN or infinity in a module's output and on a NaN in a
#: gradient (see the module docstring)
debug_nans: bool = False

FLAGS = ("diffusion_plane_layout", "debug_nans")

_nan_hook: Optional[torch.utils.hooks.RemovableHandle] = None


def set_flag(name: str, value: Any) -> None:
    """Set the flag ``name``; an unknown name raises ``AttributeError``."""
    if name not in FLAGS:
        raise AttributeError(f"unknown flag {name}")
    globals()[name] = value
    if name == "debug_nans":
        _set_nan_checks(bool(value))


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _tensors(item)


def _module_name(module: torch.nn.Module) -> str:
    return f"{type(module).__name__}({module.extra_repr()})"


def _check_output(module: torch.nn.Module, inputs, output) -> None:
    for t in _tensors(output):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            kind = "NaN" if bool(torch.isnan(t).any()) else "infinity"
            raise FloatingPointError(f"debug_nans: {kind} in the output of {_module_name(module)}")


def _set_nan_checks(on: bool) -> None:
    global _nan_hook
    if _nan_hook is not None:
        _nan_hook.remove()
        _nan_hook = None
    if on:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(_check_output)
    torch.autograd.set_detect_anomaly(on, check_nan=True)

