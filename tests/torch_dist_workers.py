"""Rank functions of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_spatial.py``,
``tests/test_torch_space.py``), started
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


def overrides(work_dir, extra=()):
    """configs/synthetic_smoke.yml at tiny width: 2 epochs of 3 steps at a
    global batch of 4 on 32² images, a checkpoint every epoch, a log record
    every step; 2 val images after epoch 2."""
    return [f"work_dir={work_dir}", "train_cfg.max_epochs=2", "train_cfg.val_interval=2",
            "train_dataloader.batch_size=4", "train_dataloader.dataset.n=12", "train_dataloader.dataset.size=32",
            "val_dataloader.batch_size=1", "val_dataloader.dataset.n=2", "val_dataloader.dataset.size=32",
            "default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 1}",
            "visualizer={'vis_backends': [{'type': 'LocalVisBackend'}]}", *TINY_OVERRIDES, *extra]


def recipe(work_dir, extra=()):
    """The :func:`overrides` recipe, loaded."""
    from dgtd_tpu_torch.core.config import load_config

    return load_config(os.path.join(ROOT, "configs", "synthetic_smoke.yml"), overrides(work_dir, extra))


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


#: (cin, cout, kernel, stride, padding, groups) of every conv geometry of
#: cod: PVT patch embeds 7/4/3 and 3/2/1, the MixFFN depthwise 3/1/1, SR
#: k = s = 8, 4, 2; ConvNeXt's stem 4/4/0, downsample 2/2/0, depthwise
#: 7/1/3; HitNet's compress_out 8/4/2 and 3x3 convs; the 1x1 convs
SPACE_CONVS = [(3, 4, 7, 4, 3, 1), (4, 6, 3, 2, 1, 1), (4, 4, 3, 1, 1, 4), (4, 4, 8, 8, 0, 1), (4, 4, 4, 4, 0, 1),
               (4, 4, 2, 2, 0, 1), (3, 4, 4, 4, 0, 1), (4, 4, 7, 1, 3, 4), (6, 4, 8, 4, 2, 1), (4, 5, 3, 1, 1, 1),
               (4, 5, 1, 1, 0, 1)]
#: (conv case, H) that the layout replicates at 2 and 4 ranks: a band that
#: does not start on a multiple of the stride (its output level banded
#: again), a level the ranks do not divide, a halo taller than the band at
#: 4 ranks (banded at 2)
SPACE_REPLICATED = [((4, 6, 3, 2, 1, 1), 15), ((4, 4, 8, 8, 0, 1), 24), ((4, 4, 7, 1, 3, 4), 8)]
#: (top, bottom) halos of a 16-row level: within a band, and taller than a
#: band of 4 and of 8 rows
SPACE_HALOS = [(1, 1), (3, 0), (0, 2), (2, 3), (7, 6), (9, 10)]


def space_rank(rank, world, init_file, out_dir, weights, b0, inputs, layouts, tiny384, val_argv):
    """``parallel/space.py`` on rank ``rank`` of ``world``: the primitives
    and the banded ``Conv2d`` under a 1×world layout; ``cod.predict`` of
    the ``b0`` settings with ``weights`` on ``inputs`` under each (data,
    space) of ``layouts``, gathered whole; the layout counts of ``tiny384``
    (settings, seed) at 384² against one process; ``-m val`` under
    ``dist.space=world`` when ``val_argv`` is given; the refusals of
    gradients. Saves what it computed, rank by rank."""
    start(rank, world, init_file)
    import numpy as np

    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.models.layers import Conv2d
    from dgtd_tpu_torch.parallel import space as S

    res = {}
    g = torch.Generator().manual_seed(0)
    sp = S.make_space(1, world)
    with S.active_space(sp):
        x = torch.randn(2, 3, 16, 5, generator=g)
        xb = S.band_rows(x)
        res["band"] = xb.clone()
        res["gather"] = S.gather_rows(xb, 16)
        res["halo"] = {tb: S.halo(xb, *tb, 16) for tb in SPACE_HALOS}
        res["halo_nhwc"] = S.halo(S.band_rows(x.permute(0, 2, 3, 1), 1), 2, 3, 16, dim=1)
        res["halo_counts"] = dict(sp.counts)
        for key, cases in (("conv", [(c, 64) for c in SPACE_CONVS]), ("conv_replicated", SPACE_REPLICATED)):
            res[key] = []
            for (cin, cout, k, s, p, groups), h in cases:
                m = Conv2d(cin, cout, k, s, p, groups=groups)
                with torch.no_grad():
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g))
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g))
                xf = torch.randn(2, cin, h, 11, generator=g)
                sp.reset_counts()
                with torch.no_grad():
                    y = S.gather_rows(m(S.band_rows(xf), h), m.out_rows(h))
                    want = torch.nn.Conv2d.forward(m, xf)
                res[key].append({"case": (cin, cout, k, s, p, groups), "h": h, "got": y, "want": want,
                                 "counts": dict(sp.counts)})
        try:
            S.gather_rows(xb.clone().requires_grad_(), 16)
        except NotImplementedError as e:
            res["grad_refused"] = str(e)
        model = cod(dtype=torch.float32, seed=None, **b0)
        model.load_state_dict(torch.load(weights), strict=False)
        img, dep = (torch.from_numpy(a) for a in inputs)
        try:
            model.loss(img, dep, dep)
        except NotImplementedError as e:
            res["loss_refused"] = str(e)
    for data, spc in layouts:
        sp = S.make_space(data, spc)
        with S.active_space(sp):
            prob, extras = model.predict(img, dep)
            counts = dict(sp.counts)
            res[f"predict_{data}x{spc}"] = {"band": prob.shape, "prob": S.gather_map(prob, img.shape[1]),
                                             "texture": S.gather_map(extras["texture"], img.shape[1]),
                                             "counts": counts}
    settings, seed = tiny384
    model = cod(dtype=torch.float32, seed=seed, **settings)
    x384 = torch.randn(1, 384, 384, 3, generator=g)
    d384 = torch.rand(1, 384, 384, 1, generator=g)
    sp = S.make_space(1, world)
    with S.active_space(sp):
        prob = S.gather_map(model.predict(x384, d384)[0], 384)
        res["tiny384"] = {"counts": dict(sp.counts), "prob": prob, "one_process": None}
    if rank == 0:
        res["tiny384"]["one_process"] = model.predict(x384, d384)[0]
    if val_argv:
        from dgtd_tpu_torch.train import cli

        res["val"] = cli.main(list(val_argv))
    torch.save(res, os.path.join(out_dir, f"space_{rank}.pt"))
    dist.destroy_process_group()
