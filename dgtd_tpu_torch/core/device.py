"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

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
