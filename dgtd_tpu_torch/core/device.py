"""Device selection for the port's entry points, and the constants kept on
each device (:func:`constant`)."""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. A CUDA request without a card raises; there is no fallback to
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or device='cpu') "
            "to run on the CPU"
        )
    return dev


#: the tensors :func:`constant` made, by key and device
CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def constant(key: Hashable, device: Union[str, torch.device], make: Callable[[], np.ndarray]) -> torch.Tensor:
    """``torch.as_tensor(make(), device=device)``, made at the first call
    for ``(key, device)`` and returned from then on. ``key`` names the array
    with everything it is computed from (its shape, a rate). A copy from
    pageable host memory to the card waits for the card's queue to drain
    and cannot run inside a CUDA graph capture: a constant of a shape pays
    it once, at its first use. Callers read it and never write into it.
    While a program is traced (``torch.export``, ``torch.compile``) the
    array is made afresh, a constant of the traced program, and not kept."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return torch.as_tensor(make(), device=device)
    slot = (key, torch.device(device))
    t = CONSTANTS.get(slot)
    if t is None:
        t = CONSTANTS[slot] = torch.as_tensor(make(), device=device)
    return t
