"""Train or validate from a recipe (counterpart of the root ``train.py``):

    python -m dgtd_tpu_torch.train configs/cod.yml -o work_dir=./output/run \\
        [-o key=value ...] [-m val] [--fp32] [--resume work_dir/epoch_N.pth] [--device cpu]

bf16 autocast with fp32 parameters unless ``--fp32``. ``-m val`` runs the
val pass alone (``-o save_visualizations=true`` dumps PNGs; the recipe's
``our_init.val_ckpt`` names the weights), as ``python -m dgtd_tpu_torch.test``
does. Runs on CUDA unless ``--device`` names another device; a missing card
raises.

Data-parallel on N ranks (``train_dataloader.batch_size`` stays the global
batch; N must divide it):

    torchrun --nproc_per_node=N -m dgtd_tpu_torch.train configs/cod.yml -o work_dir=./output/run

Rank r runs on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo).
SLURM and OMPI launches of more than one task start the group too, and
``-o dist.coordinator=host:port`` names a ``tcp://`` rendezvous
(``parallel/dist.py::detect_launch``). ``-o dist.space=N`` with N > 1, the
JAX package's data×space step, raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse

import torch

from ..core.config import get_dotted, load_config
from ..parallel import dist as pdist
from .loop import Runner


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("-o", "--override", action="append", default=[], help="dotted key=value")
    ap.add_argument("-m", "--mode", default="train", choices=["train", "val"])
    ap.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    ap.add_argument("--resume", default=None, help="checkpoint path to resume from")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI. Train mode returns the Runner's summary plus
    ``work_dir``; val mode returns the metrics."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.override)
    pdist.refuse_space(get_dotted(cfg, "dist.space", 1))
    device, started = pdist.init_distributed(get_dotted(cfg, "dist.coordinator"), args.device)
    try:
        work_dir = get_dotted(cfg, "work_dir", "./output/run")
        runner = Runner(cfg, work_dir=work_dir, seed=int(get_dotted(cfg, "seed", 0)), device=device,
                        dtype=torch.float32 if args.fp32 else torch.bfloat16, mode=args.mode)
        if args.resume:
            runner.resume(args.resume)
        if args.mode == "val":
            return runner.val(save_visualizations=bool(get_dotted(cfg, "save_visualizations", False)))
        summary = runner.train()
        return {**summary, "work_dir": work_dir}
    finally:
        if started:
            pdist.destroy()
