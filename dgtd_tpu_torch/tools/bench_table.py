"""Every dataset, one checkpoint, one process: the E/F/S/MAE table
(counterpart of ``dgtd_tpu/tools/bench_table.py``).

The model and checkpoint load once; each dataset then goes through
``Runner.val``. Prints the markdown table and one JSON line:

    python -m dgtd_tpu_torch.tools.bench_table --config configs/cod.yml \\
        --checkpoint work_dir/epoch_100.pth \\
        --dataset COD10K_TEST:/data/COD10K --dataset COD_TEST:/data/CAMO \\
        --dataset CHAMELEON:/data/CHAMELEON --dataset NC4K:/data/NC4K \\
        [--depth-dir Depth_popnet] [--batch-size 1] [--image-size N] [-o key=value] \\
        [--fp32] [--device cpu] [--out table.md]

A dataset is ``TYPE:data_dir[:depth_dir]``; the registered dataset class
gives its resolution unless ``--image-size`` sets every one. The checkpoint
is what ``restore_checkpoint`` reads (a ``.pth`` state dict or a JAX flat
``.npz``). Runs on CUDA unless ``--device`` names another device (a missing
card raises), in bf16 autocast unless ``--fp32``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch


def _parse_spec(spec: str, default_depth: str):
    parts = spec.split(":")
    if len(parts) == 2:
        return parts[0], parts[1], default_depth
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    raise SystemExit(f"--dataset expects TYPE:data_dir[:depth_dir], got {spec!r}")


def run_table(config: str, checkpoint: Optional[str], dataset_specs: List[str], depth_dir: str = "Depth_popnet",
              batch_size: int = 1, overrides: Optional[List[str]] = None, dtype: torch.dtype = torch.bfloat16,
              image_size: Optional[int] = None, device: Optional[torch.device] = None) -> dict:
    """{"TYPE:data_dir": the val metrics} for each dataset, in order."""
    from ..core.config import get_dotted, load_config
    from ..train.loop import Runner

    cfg = load_config(config, overrides or [])
    blocks = []
    for spec in dataset_specs:
        ds_type, data_dir, ds_depth = _parse_spec(spec, depth_dir)
        ds_cfg = {"type": ds_type, "data_dir": data_dir, "depth_dir": ds_depth, "split": "val"}
        if image_size is not None:
            ds_cfg["image_size"] = image_size
        blocks.append((f"{ds_type}:{data_dir}",
                       {"batch_size": batch_size, "dataset": ds_cfg, "sampler": {"shuffle": False}}))
    # the Runner's val loader is the first dataset's; each dataset's replaces it
    cfg["val_dataloader"] = blocks[0][1]
    runner = Runner(cfg, work_dir=get_dotted(cfg, "work_dir", "./output/bench_table"),
                    seed=int(get_dotted(cfg, "seed", 0)), device=device, dtype=dtype, mode="val")
    if checkpoint:
        runner.restore_checkpoint(checkpoint)
    rows = {}
    for name, block in blocks:
        runner.cfg["val_dataloader"] = block
        runner.val_loader = runner._build_val_loader()
        rows[name] = runner.val()
    return rows


def format_markdown(rows: dict) -> str:
    metric_keys: List[str] = []
    for res in rows.values():
        for k in res:
            if k.startswith("COD/") and not k.endswith("_strict") and k not in metric_keys:
                metric_keys.append(k)
    lines = ["| dataset | " + " | ".join(k.split("/", 1)[1] for k in metric_keys) + " |"]
    lines.append("|" + "---|" * (len(metric_keys) + 1))
    for name, res in rows.items():
        vals = " | ".join(f"{res.get(k, float('nan')):.4f}" for k in metric_keys)
        lines.append(f"| {name} | {vals} |")
    return "\n".join(lines)


def main(argv=None):
    from ..core.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/cod.yml")
    ap.add_argument("--checkpoint", default=None, help="a .pth state dict or a JAX flat .npz")
    ap.add_argument("--dataset", action="append", required=True, help="TYPE:data_dir[:depth_dir]; repeatable")
    ap.add_argument("--depth-dir", default="Depth_popnet")
    ap.add_argument("--batch-size", type=int, default=1, help="the reference's val batch is 1")
    ap.add_argument("-o", "--override", action="append", default=[], help="dotted config overrides")
    ap.add_argument("--image-size", type=int, default=None,
                    help="every dataset's resolution (default: each dataset's own)")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=None, help="also write the markdown table here")
    args = ap.parse_args(argv)
    rows = run_table(args.config, args.checkpoint, args.dataset, depth_dir=args.depth_dir,
                     batch_size=args.batch_size, overrides=args.override,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16, image_size=args.image_size,
                     device=resolve_device(args.device))
    table = format_markdown(rows)
    print(table)
    print(json.dumps({"benchmark_table": rows}))
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
