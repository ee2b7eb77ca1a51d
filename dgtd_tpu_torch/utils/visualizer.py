"""Visualization backends (counterpart of ``dgtd_tpu/utils/visualizer.py``).

The reference's ``visualizer.vis_backends`` block, with the optional
``ClearMLVisBackend`` (commented out of both recipes). ``LocalVisBackend``
writes a ``scalars.jsonl`` and PNGs under the work dir; ``ClearMLVisBackend``
writes the same files and reports to clearml as well when the package
imports.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..core.registry import VIS_BACKENDS


@VIS_BACKENDS.register
class LocalVisBackend:
    def __init__(self, save_dir: str = "./output/vis", project: Optional[str] = None):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self._scalar_path = os.path.join(save_dir, "scalars.jsonl")

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        # opened per write: a backend has no close() and lives as long as its
        # Runner, so a held handle would leak and could lose the last record
        with open(self._scalar_path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")

    def add_image(self, name: str, image: np.ndarray, step: int = 0) -> None:
        from PIL import Image

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        Image.fromarray(arr).save(os.path.join(self.save_dir, f"{name}_{step}.png"))


@VIS_BACKENDS.register
class ClearMLVisBackend(LocalVisBackend):
    """The local files, and clearml's scalars when ``clearml`` imports."""

    def __init__(self, save_dir: str = "./output/vis", project: str = "COD", **kwargs):
        super().__init__(save_dir=save_dir)
        self._task = None
        try:
            from clearml import Task
        except ImportError:
            return
        self._task = Task.init(project_name=project, task_name="dgtd_tpu_torch")

    def add_scalars(self, scalars, step):
        super().add_scalars(scalars, step)
        if self._task is not None:
            for k, v in scalars.items():
                self._task.get_logger().report_scalar("train", k, v, step)


def build_visualizer(cfg: Optional[dict], work_dir: str) -> List[LocalVisBackend]:
    """The backends of a reference-schema ``visualizer`` block; each saves
    under ``work_dir/vis`` unless it names a ``save_dir``."""
    if not cfg:
        return []
    backends = []
    for b in cfg.get("vis_backends", []) or []:
        b = dict(b)
        b.setdefault("save_dir", os.path.join(work_dir, "vis"))
        backends.append(VIS_BACKENDS.build(b))
    return backends
