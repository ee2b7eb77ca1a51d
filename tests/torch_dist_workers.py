"""Rank functions of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_spatial.py``), started
with ``torch.multiprocessing.spawn`` over gloo and a ``file://`` rendezvous.
This module imports torch and the port only, so that a spawned rank
imports no JAX; each rank writes what it computed under ``out_dir``.
"""

import os
import signal

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tiny cod at the recipe's grid 12; the drop-path rates stay the recipe's
#: 0.1 (PVT) and 0.4 (ConvNeXt)
TINY_OVERRIDES = ["model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
                  "model.channel=8", "model.latent_dim=8", "model.grid=12", "model.refine_iters=2"]


def recipe(work_dir, extra=()):
    """configs/synthetic_smoke.yml at tiny width: 2 epochs of 3 steps at a
    global batch of 4 on 32² images, a checkpoint every epoch, a log record
    every step; 2 val images after epoch 2."""
    from dgtd_tpu_torch.core.config import load_config

    ovs = [f"work_dir={work_dir}", "train_cfg.max_epochs=2", "train_cfg.val_interval=2",
           "train_dataloader.batch_size=4", "train_dataloader.dataset.n=12", "train_dataloader.dataset.size=32",
           "val_dataloader.batch_size=1", "val_dataloader.dataset.n=2", "val_dataloader.dataset.size=32",
           "default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 1}",
           "visualizer={'vis_backends': [{'type': 'LocalVisBackend'}]}", *TINY_OVERRIDES, *extra]
    return load_config(os.path.join(ROOT, "configs", "synthetic_smoke.yml"), ovs)


def start(rank, world, init_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)


def _record_hook(snapshot_step, out_dir, rank, sigterm_step=None, sigterm_rank=None):
    from dgtd_tpu_torch.train.hooks import Hook

    class Record(Hook):
        """Keeps every step's loss terms; saves the parameters and BatchNorm
        statistics after ``snapshot_step``; sends this rank SIGTERM after
        ``sigterm_step`` when it is ``sigterm_rank``."""

        def __init__(self):
            self.losses = []

        def after_train_iter(self, runner, metrics):
            self.losses.append({k: float(v) for k, v in metrics.items()})
            if runner.host_step == snapshot_step:
                torch.save(runner.model.state_dict(), os.path.join(out_dir, f"state_{rank}_step{snapshot_step}.pt"))
            if runner.host_step == sigterm_step and rank == sigterm_rank:
                os.kill(os.getpid(), signal.SIGTERM)

    return Record()


def train_rank(rank, world, init_file, out_dir, extra=(), snapshot_step=3, sigterm=None, resume=None):
    """Train the tiny recipe on rank ``rank`` of ``world`` (work dir
    ``out_dir/rank<r>``); saves the per-step losses, the summary, the final
    state and, under ``sigterm`` = (step, rank), sends that rank SIGTERM
    after that step; ``resume`` is a checkpoint every rank resumes from."""
    start(rank, world, init_file)
    from dgtd_tpu_torch.parallel import dist as pdist
    from dgtd_tpu_torch.train.loop import Runner

    work_dir = os.path.join(out_dir, f"rank{rank}")
    runner = Runner(recipe(work_dir, extra), work_dir=work_dir, seed=0, device=torch.device("cpu"),
                    dtype=torch.float32)
    rec = _record_hook(snapshot_step, out_dir, rank, *(sigterm or (None, None)))
    runner.hooks.append(rec)
    if resume:
        runner.resume(resume)
    summary = runner.train()
    means = pdist.all_mean({"rank": float(rank), "one": 1.0})
    torch.save({"losses": rec.losses, "summary": summary, "state": runner.model.state_dict(),
                "rows": len(runner.train_loader), "means": means},
               os.path.join(out_dir, f"result_{rank}.pt"))
    pdist.destroy()


def spatial_rank(rank, world, init_file, out_dir, cases):
    """``parallel/spatial.py::spatial_diffusion`` on this rank's rows of
    each case's (x, w, kernel, steps); a case whose shards the function
    refuses records the error's message. Saves {case index: shard or
    message}."""
    start(rank, world, init_file)
    from dgtd_tpu_torch.parallel import spatial

    results = {}
    for i, (x, w, kernel, steps) in enumerate(cases):
        try:
            xs = spatial.shard_rows(torch.from_numpy(x))
            ws = spatial.shard_rows(torch.from_numpy(w))
            results[i] = spatial.spatial_diffusion(xs, ws, kernel, steps)
        except ValueError as e:
            results[i] = str(e)
    torch.save(results, os.path.join(out_dir, f"spatial_{rank}.pt"))
    dist.destroy_process_group()
