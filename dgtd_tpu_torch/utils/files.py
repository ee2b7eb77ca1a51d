"""Host-side file-listing helpers (copy of ``dgtd_tpu/utils/files.py``)."""

from __future__ import annotations

import os
from typing import List

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def list_images(d: str, required: bool = True) -> List[str]:
    """Sorted image filenames in ``d`` — image extensions only, so a stray
    non-image entry (.DS_Store, a subdirectory) can neither crash Image.open
    nor shift sorted-order pairing."""
    files = sorted(f for f in os.listdir(d) if f.lower().endswith(IMAGE_EXTS))
    if required and not files:
        raise SystemExit(f"no image files in {d}")
    return files
