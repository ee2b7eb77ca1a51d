"""Evaluate a recipe's val set (counterpart of the root ``test.py`` and of
``scripts/test.sh``): the train CLI with ``-m val``.

    python -m dgtd_tpu_torch.test configs/sod.yml -o work_dir=./output/val \\
        [-o custom_hooks.0.val_ckpt=work_dir/epoch_50.pth] [-o save_visualizations=true] [--device cpu]

Prints one JSON metrics line (E/F/S/MAE, parity and strict, and
``val_imgs_per_sec``). Runs on CUDA unless ``--device`` names another
device; a missing card raises. Under ``torchrun`` every rank scores the
whole val set and rank 0 prints the ranks' mean (``train/cli.py``).
"""

from __future__ import annotations

import sys

from .train import cli


def main(argv=None):
    """Run the val pass; returns the metrics."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return cli.main(argv + ["-m", "val"])


if __name__ == "__main__":
    main()
