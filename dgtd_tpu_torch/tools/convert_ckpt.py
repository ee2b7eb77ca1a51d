"""JAX checkpoint -> the port's state dict (the port side of
``dgtd_tpu/tools/convert_ckpt.py``).

    python -m dgtd_tpu_torch.tools.convert_ckpt {full,dinov2,dpt_head} in.npz out.pth

``full``: a segmentation model's flat ``.npz`` (``cod``, ``baseline`` or
``DQnet``: ``{'params/...', 'batch_stats/...'}``, a bare key meaning
``params/``), written in the port's (the reference's) key schema, which
``predict --checkpoint`` and ``restore_checkpoint`` load. ``dinov2`` and
``dpt_head``: a depther part (bare paths, as the JAX ``convert_ckpt``
writes them, or a depther's tree under ``backbone/`` / ``decode_head/``),
written with the official DINOv2 and mmseg head keys, which
``depth_gen --backbone-ckpt`` / ``--head-ckpt`` load. ``convert.py`` holds
the key tables; a leaf they do not map raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..convert import state_dict_from_flax

KINDS = ("full", "dinov2", "dpt_head")


def convert(kind: str, src: str, dst: str):
    """Write the port's state dict of ``src`` to ``dst``; returns (tensors
    converted, JAX leaves left out: those of the other depther part)."""
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    state = state_dict_from_flax(flat, kind)
    torch.save(state, dst)
    return len(state), len(flat) - len(state)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 3 or argv[0] not in KINDS:
        print(__doc__)
        return 1
    kind, src, dst = argv
    n, skipped = convert(kind, src, dst)
    print(f"converted {n} tensors -> {dst}; skipped {skipped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
