"""Rank functions of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_spatial.py``,
``tests/test_torch_space.py``, ``tests/test_torch_space_train.py``), started
with ``torch.multiprocessing.spawn`` over gloo and a ``file://`` rendezvous.
This module imports torch and the port only, so that a spawned rank
imports no JAX; each rank writes what it computed under ``out_dir``.
"""

import contextlib
import os
import signal
import threading

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tiny cod at the recipe's grid 12; the drop-path rates stay the recipe's
#: 0.1 (PVT) and 0.4 (ConvNeXt)
TINY_OVERRIDES = ["model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
                  "model.channel=8", "model.latent_dim=8", "model.grid=12", "model.refine_iters=2"]


#: tiny DQnet (tests/test_torch_dqnet.py's): PVT ``tiny``, channel 8, the
#: default cross_size 44; its drop-path rate stays the PVT's 0.1
DQ = dict(variant="tiny", channel=8)
#: the train CLI's DQnet overrides (as chip_smoke.py's phase 17 gives
#: them): its own model block, the PVT's lr multiplier on its top-level
#: ``backbone`` (the recipe's key names cod's), its init hook
DQ_CLI = ["model={'type': 'DQnet', 'variant': 'tiny', 'channel': 8}",
          "optim_wrapper.paramwise_cfg.custom_keys={'backbone': {'lr_mult': 0.2}}",
          "custom_hooks=[{'type': 'PretrainInitHook'}]"]
#: one train step of 4 images, then the val pass
ONE_STEP = ["train_cfg.max_epochs=1", "train_cfg.val_interval=1", "train_dataloader.dataset.n=4"]


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


def space_rank(rank, world, init_file, out_dir, weights, b0, inputs, layouts, tiny384, val_argvs, dqnet):
    """``parallel/space.py`` on rank ``rank`` of ``world``: the primitives
    and the banded ``Conv2d`` under a 1×world layout; ``cod.predict`` of
    the ``b0`` settings with ``weights`` on ``inputs`` under each (data,
    space) of ``layouts``, gathered whole; ``DQnet.predict`` of ``dqnet``
    (weights, settings) the same way, with the layout's counts of each
    prompt's and the cue grid's resize; the layout counts of ``tiny384``
    (settings, seed) at 384² against one process; each argv of
    ``val_argvs`` ({name: argv}: ``-m val`` under ``dist.space=world``).
    Saves what it computed, rank by rank."""
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
    model = cod(dtype=torch.float32, seed=None, **b0)
    model.load_state_dict(torch.load(weights), strict=False)
    img, dep = (torch.from_numpy(a) for a in inputs)
    for data, spc in layouts:
        sp = S.make_space(data, spc)
        with S.active_space(sp):
            prob, extras = model.predict(img, dep)
            counts = dict(sp.counts)
            res[f"predict_{data}x{spc}"] = {"band": prob.shape, "prob": S.gather_map(prob, img.shape[1]),
                                             "texture": S.gather_map(extras["texture"], img.shape[1]),
                                             "counts": counts}
    res.update(_dqnet_predicts(S, dqnet, img, dep, layouts))
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
    from dgtd_tpu_torch.train import cli

    for name, argv in val_argvs.items():
        res[name] = cli.main(list(argv))
    torch.save(res, os.path.join(out_dir, f"space_{rank}.pt"))
    dist.destroy_process_group()


def _counted(module, name, log):
    """Replace ``module.name`` (a function) by one that appends the active
    layout's counts that each call adds to ``log``; returns the undo."""
    from dgtd_tpu_torch.parallel import space as S

    fn = getattr(module, name)

    def spy(*args, **kwargs):
        before = dict(S.current().counts)
        out = fn(*args, **kwargs)
        log.append({k: v - before[k] for k, v in S.current().counts.items() if v != before[k]})
        return out

    setattr(module, name, spy)
    return lambda: setattr(module, name, fn)


def _dqnet_predicts(S, dqnet, img, dep, layouts):
    """``DQnet.predict`` of ``dqnet`` (weights, settings) on (img, dep) under
    each (data, space) of ``layouts``: the gathered probability, the band's
    shape, the counts, and the counts that each prompt's resize to its stage
    and the cue grid's resize added."""
    from dgtd_tpu_torch.models import dqnet as MQ
    from dgtd_tpu_torch.models import pvt

    weights, settings = dqnet
    model = MQ.DQnet(dtype=torch.float32, seed=None, **settings)
    model.load_state_dict(torch.load(weights))
    out = {}
    for data, spc in layouts:
        sp = S.make_space(data, spc)
        prompts, cues = [], []
        undo = [_counted(pvt, "resize_to_band", prompts), _counted(MQ, "resize_gathered", cues)]
        try:
            with S.active_space(sp):
                prob = model.predict(img, dep)[0]
                counts = dict(sp.counts)
                out[f"dqnet_{data}x{spc}"] = {"band": prob.shape, "prob": S.gather_map(prob, img.shape[1]),
                                              "counts": counts, "prompts": prompts, "cues": cues}
        finally:
            for u in undo:
                u()
    return out


# ---------------------------------------------------------------- the train step under the data×space layout

#: the adjoint cases of tests/test_torch_space_train.py: halos within and
#: taller than a band (NCHW and NHWC), the all-gather, the spatial mean,
#: every conv geometry of cod banded and the layouts it replicates, the
#: stencil in plane and NHWC layout on halo'd bands
ADJOINT_CASES = ([("halo", tb) for tb in SPACE_HALOS] + [("halo_nhwc", (2, 3)), ("gather", None), ("mean", None)]
                 + [("conv", i) for i in range(len(SPACE_CONVS))]
                 + [("conv_replicated", i) for i in range(len(SPACE_REPLICATED))]
                 + [("planes", None), ("nhwc", None)])
#: the stencil cases' kernel and steps (3 rows of halo: a band of 4 at 4 ranks holds it)
ADJOINT_KERNEL, ADJOINT_STEPS = 7, 2


def adjoint_inputs(i):
    """Case ``i``'s whole inputs, seeded by ``i``: {"x", and "w" (the
    stencil's normalized weights) or "conv" (a seeded ``Conv2d``) with the
    level's height "h"}; H is dim -2 (NCHW), 1 (NHWC, planes)."""
    from dgtd_tpu_torch.models.layers import Conv2d

    g = torch.Generator().manual_seed(100 + i)
    kind, arg = ADJOINT_CASES[i]
    kk = ADJOINT_KERNEL ** 2
    if kind == "halo_nhwc":
        return {"x": torch.randn(2, 16, 5, 3, generator=g)}
    if kind in ("halo", "gather", "mean"):
        return {"x": torch.randn(2, 3, 16, 5, generator=g)}
    if kind == "planes":
        w = torch.rand(3, kk, 16, 7, generator=g)
        return {"x": torch.randn(3, 16, 7, generator=g), "w": w / w.sum(1, keepdim=True)}
    if kind == "nhwc":
        w = torch.rand(2, 16, 7, 3, kk, generator=g)
        return {"x": torch.randn(2, 16, 7, 3, generator=g), "w": w / w.sum(-1, keepdim=True)}
    (cin, cout, k, s, p, groups), h = (SPACE_CONVS[arg], 64) if kind == "conv" else SPACE_REPLICATED[arg]
    m = Conv2d(cin, cout, k, s, p, groups=groups)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    return {"x": torch.randn(2, cin, h, 11, generator=g), "conv": m, "h": h}


def adjoint_cotangent(i, rank, shape):
    """The cotangent rank ``rank`` applies to case ``i``'s output."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(10000 + 100 * i + rank))


def _adjoint(S, spatial, i, rank):
    """Case ``i`` on this rank's band under the active layout: the forward,
    then the backward of <cotangent, output>; the bands' gradients and the
    conv's parameter gradients."""
    kind, arg = ADJOINT_CASES[i]
    inp = adjoint_inputs(i)
    dim = -2 if kind in ("halo", "gather", "mean") or kind.startswith("conv") else 1
    x = S.band_rows(inp["x"], dim).clone().requires_grad_()
    bands = [x]
    if kind == "halo":
        y = S.halo(x, *arg, 16)
    elif kind == "halo_nhwc":
        y = S.halo(x, *arg, 16, dim=1)
    elif kind == "gather":
        y = S.gather_rows(x, 16)
    elif kind == "mean":
        y = S.spatial_mean(x, 16)
    elif kind.startswith("conv"):
        y = inp["conv"](x, inp["h"])
    else:
        w = S.band_rows(inp["w"], 2 if kind == "planes" else 1).clone().requires_grad_()
        bands.append(w)
        fn = spatial.spatial_planes if kind == "planes" else spatial.spatial_nhwc
        y = fn(x, w, ADJOINT_KERNEL, ADJOINT_STEPS, S.current().space_group)
    (y * adjoint_cotangent(i, rank, y.shape)).sum().backward()
    params = {n: p.grad for n, p in inp["conv"].named_parameters()} if "conv" in inp else {}
    return {"grads": [b.grad for b in bands], "params": params, "out_shape": tuple(y.shape)}


def _grab_optimizer(opt, model, keep):
    """``opt`` that first copies the (averaged) gradients of step 0 into
    ``keep``, as the train step hands them to the optimizer."""

    class Grab:
        def step(self, step):
            if step == 0:
                keep.update({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
            return opt.step(step)

    return Grab()


@contextlib.contextmanager
def _backward_on_a_thread(on):
    """With ``on``, ``train/state.py::backward`` runs ``loss.backward()`` on
    a fresh thread, whose context holds no layout (as the thread of a CUDA
    backward)."""
    from dgtd_tpu_torch.train import state

    if not on:
        yield
        return
    backward = state.backward

    def on_a_thread(loss):
        err = []

        def run():
            try:
                backward(loss)
            except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
                err.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if err:
            raise err[0]

    state.backward = on_a_thread
    try:
        yield
    finally:
        state.backward = backward


def space_model(family, extra=None):
    """``cod`` (``extra``'s ``type`` instead, if it names one) of its
    family's settings and ``extra``'s other keys, fp32, seeded 0, then
    every entry of its family's state whose key and shape it shares
    (``baseline``'s weight regressor is another shape than ``cod``'s).
    ``family``: {"cod": (state, settings), "DQnet": (state, settings)}
    (``baseline`` is of cod's). ``extra``'s ``no_drop`` sets every
    drop-path rate to 0 (DQnet takes none)."""
    from dgtd_tpu_torch import models  # noqa: F401  (registers the models)
    from dgtd_tpu_torch.core.registry import MODELS
    from dgtd_tpu_torch.models.layers import DropPath

    extra = dict(extra or {})
    kind, no_drop = extra.pop("type", "cod"), extra.pop("no_drop", False)
    state, settings = family["DQnet" if kind == "DQnet" else "cod"]
    model = MODELS.get(kind)(dtype=torch.float32, seed=0, **{**settings, **extra})
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in state.items() if k in own and own[k].shape == v.shape}, strict=False)
    for m in model.modules():
        if no_drop and isinstance(m, DropPath):
            m.rate = 0.0
    return model


def space_train_leg(model, optim_cfg, batches, layout, on_a_thread=False):
    """AdamW train steps (``train/state.py::train_step``) of ``model`` on
    ``batches`` (whole global batches, NHWC numpy) under ``layout`` (None:
    one process): each step's loss terms, the averaged step-0 gradients,
    the state after the steps and the layout's counts of step 0.
    ``on_a_thread``: the first batch only, its backward on a fresh
    thread."""
    from dgtd_tpu_torch.parallel import space as S
    from dgtd_tpu_torch.parallel.dist import row_slice
    from dgtd_tpu_torch.train.optim import Optimizer
    from dgtd_tpu_torch.train.state import train_step

    opt = Optimizer(model.named_parameters(), optim_cfg, 1, len(batches), frozen_prefixes=model.frozen_param_prefixes)
    grads = {}
    grab = _grab_optimizer(opt, model, grads)
    losses, counts = [], None
    for step, b in enumerate(batches[:1] if on_a_thread else batches):
        rows = slice(None) if layout is None else row_slice(b["input"].shape[0], layout.data_index, layout.data)
        batch = {k: torch.from_numpy(v[rows]) for k, v in b.items()}
        if layout is not None:
            layout.reset_counts()
        with S.active_space(layout), _backward_on_a_thread(on_a_thread):
            aux = train_step(model, grab, batch, step, seed=1)
        losses.append({k: float(v) for k, v in aux.items()})
        if step == 0 and layout is not None:
            counts = dict(layout.counts)
    return {"losses": losses, "grads": grads, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "counts": counts}


def space_train_rank(rank, world, init_file, out_dir, weights, settings, batches, optim_cfg, legs, cli_root=None):
    """The train step under the data×space layout on rank ``rank`` of
    ``world``: every case of :data:`ADJOINT_CASES` and of
    :data:`FUSION_CASES` under a 1×world layout; each leg of ``legs``
    ((name, (data, space), model overrides, on_a_thread)):
    :func:`space_model` of its family's ``weights`` and ``settings`` (each
    {"cod": …, "DQnet": …}) and the overrides, :func:`space_train_leg` on
    ``batches`` with its family's ``optim_cfg``; with ``cli_root`` the tiny recipe through the train CLI
    data-parallel (2, 1) and its epoch-1 checkpoint resumed under ``-o
    dist.space=world``, and tiny DQnet's step and val pass through the CLI
    under ``-o dist.space=world``. Saves what it computed, rank by rank."""
    start(rank, world, init_file)
    from dgtd_tpu_torch.parallel import space as S
    from dgtd_tpu_torch.parallel import spatial

    res = {"adjoints": {}, "fusion": {}}
    with S.active_space(S.make_space(1, world)):
        for i in range(len(ADJOINT_CASES)):
            res["adjoints"][i] = _adjoint(S, spatial, i, rank)
        for i in range(len(FUSION_CASES)):
            res["fusion"][i] = _fusion(S, i, rank)
    family = {k: (torch.load(weights[k]), settings[k]) for k in weights}
    for name, (data, spc), extra, on_a_thread in legs:
        cfg = optim_cfg["DQnet" if extra.get("type") == "DQnet" else "cod"]
        res[name] = space_train_leg(space_model(family, extra), cfg, batches, S.make_space(data, spc), on_a_thread)
    if cli_root:
        res["cli"] = _cli_resume_leg(rank, world, cli_root)
        res["cli_dqnet"] = cli_run(train_argv(os.path.join(cli_root, f"dq{rank}"),
                                              ONE_STEP + DQ_CLI + [f"dist.space={world}"]), cli_root, rank)
    torch.save(res, os.path.join(out_dir, f"space_train_{rank}.pt"))
    dist.destroy_process_group()


def train_argv(work_dir, extra=()):
    """The train CLI's argv for the :func:`overrides` recipe on the CPU."""
    argv = [os.path.join(ROOT, "configs", "synthetic_smoke.yml"), "--device", "cpu", "--fp32"]
    for o in overrides(work_dir, extra):
        argv += ["-o", o]
    return argv


def _cli_resume_leg(rank, world, root):
    """The tiny recipe through the train CLI data-parallel on every rank
    (dist.space=1), then its epoch-1 checkpoint resumed under
    ``-o dist.space=world`` for epoch 2: for each run the state just
    before its first step and at its end, its loss terms and its summary."""
    from dgtd_tpu_torch.train import cli, loop

    runs = []
    train = loop.Runner.train

    def recorded_train(self):
        rec = _record_hook(None, root, rank)
        self.hooks.append(rec)
        run = {"before": {k: v.clone() for k, v in self.model.state_dict().items()}}
        run["summary"] = train(self)
        run.update(after={k: v.clone() for k, v in self.model.state_dict().items()}, losses=rec.losses)
        runs.append(run)
        return run["summary"]

    loop.Runner.train = recorded_train
    try:
        cli.main(train_argv(os.path.join(root, f"dp{rank}")))
        ckpt = os.path.join(root, "dp0", "epoch_1.pth")
        cli.main(train_argv(os.path.join(root, f"space{rank}"), [f"dist.space={world}"]) + ["--resume", ckpt])
    finally:
        loop.Runner.train = train
    return {"dp": runs[0], "space": runs[1]}


def cli_run(argv, root, tag):
    """The train CLI on ``argv`` (every rank of a started group, or one
    process), recorded: every step's loss terms, each val pass's metrics
    and the state at the end."""
    from dgtd_tpu_torch.train import cli, loop

    rec = _record_hook(None, root, tag)
    vals, end = [], {}
    train, val = loop.Runner.train, loop.Runner.val

    def recorded_train(self):
        self.hooks.append(rec)
        out = train(self)
        end.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return out

    def recorded_val(self, *args, **kwargs):
        vals.append(val(self, *args, **kwargs))
        return vals[-1]

    loop.Runner.train, loop.Runner.val = recorded_train, recorded_val
    try:
        summary = cli.main(argv)
    finally:
        loop.Runner.train, loop.Runner.val = train, val
    return {"summary": summary, "losses": rec.losses, "vals": vals, "after": end}


# ---------------------------------------------------------------- the fusion modules and the MPRNet blocks on bands

#: (case, the input level's global height): WindowFusion where a band's rows
#: are a multiple of its window (16 rows: bands of 8 and 4) and where they
#: are not (20 rows: bands of 10 and 5, the window 4), gathered in both;
#: NewWindowFusion;
#: the MPRNet encoder, decoder and cross-stage encoder; ORSNet; the three
#: resizers. Every map is 20 wide
FUSION_CASES = [("window", 16), ("window", 20), ("new_window", 20), ("encoder_decoder", 24), ("orsnet", 24),
                ("resizers", 24)]
FUSION_W, FUSION_DIM, FUSION_WIN, FUSION_HEADS = 20, 16, 4, 2
#: MPRNet widths: n_feat, scale_unetfeats, scale_orsnetfeats, CABs an ORB
MPR_FEAT, MPR_UNET, MPR_ORS, MPR_CABS = 16, 8, 4, 2


def fusion_case(i):
    """Case ``i``'s seeded modules (an ``nn.ModuleDict``; the JAX package's
    initializers, and random relative position tables) and its whole
    inputs with their global heights: [(tensor, height)]; fp32."""
    import torch.nn as nn

    from dgtd_tpu_torch.models import mprnet as PM
    from dgtd_tpu_torch.models import window_fusion as PW
    from dgtd_tpu_torch.models.layers import init_parameters

    kind, h = FUSION_CASES[i]
    g = torch.Generator().manual_seed(200 + i)
    w = FUSION_W
    if kind == "window":
        mods = {"m": PW.WindowFusion(FUSION_DIM, window=FUSION_WIN, num_heads=FUSION_HEADS)}
    elif kind == "new_window":
        mods = {"m": PW.NewWindowFusion(FUSION_DIM, num_heads=FUSION_HEADS)}
    elif kind == "encoder_decoder":
        mods = {"enc": PM.Encoder(MPR_FEAT, scale_unetfeats=MPR_UNET), "dec": PM.Decoder(MPR_FEAT, scale_unetfeats=MPR_UNET),
                "enc2": PM.Encoder(MPR_FEAT, bias=True, scale_unetfeats=MPR_UNET, csff=True)}
    elif kind == "orsnet":
        mods = {"m": PM.ORSNet(MPR_FEAT, MPR_ORS, bias=True, scale_unetfeats=MPR_UNET, num_cab=MPR_CABS)}
    else:
        mods = {"down": PM.DownSample(MPR_FEAT, MPR_UNET), "up": PM.UpSample(MPR_FEAT, MPR_UNET),
                "skip": PM.SkipUpSample(MPR_FEAT, MPR_UNET)}
    mods = init_parameters(nn.ModuleDict(mods), g)
    with torch.no_grad():
        for n, p in mods.named_parameters():
            if "rel_pos" in n:
                p.copy_(torch.randn(p.shape, generator=g))
    if kind in ("window", "new_window"):
        shapes = [((2, FUSION_DIM, h, w), h)] * 2
    elif kind == "encoder_decoder":
        shapes = [((1, MPR_FEAT, h, w), h)]
    elif kind == "orsnet":
        levels = [(h, w), (h // 2, w // 2), (h // 4, w // 4)]
        shapes = [((1, MPR_FEAT + MPR_ORS, h, w), h)] + [
            ((1, MPR_FEAT + j * MPR_UNET, *levels[j]), levels[j][0]) for _ in range(2) for j in range(3)]
    else:
        shapes = [((1, MPR_FEAT, h, w), h), ((1, MPR_FEAT + MPR_UNET, h // 2, w // 2), h // 2),
                  ((1, MPR_FEAT, h, w), h)]
    return mods, [(torch.randn(shape, generator=g), hh) for shape, hh in shapes]


def fusion_forward(i, mods, xs, h):
    """Case ``i``'s outputs on inputs ``xs`` (bands under a layout, whole
    without one), the first at a level of ``h`` global rows: [(output, its
    global height)]."""
    kind = FUSION_CASES[i][0]
    if kind == "window":
        out, gate = mods["m"](*xs, h=h)
        return [(out, h), (gate, h)]
    if kind == "new_window":
        return [(mods["m"](*xs, h=h), h)]
    heights = [h, h // 2, h // 4]
    if kind == "encoder_decoder":
        enc = mods["enc"](xs[0], h=h)
        dec = mods["dec"](enc, h=h)
        enc2 = mods["enc2"](xs[0], enc, dec, h=h)
        return list(zip(enc + dec + enc2, heights * 3))
    if kind == "orsnet":
        return [(mods["m"](xs[0], xs[1:4], xs[4:7], h=h), h)]
    return [(mods["down"](xs[0], h), h // 2), (mods["up"](xs[1], h // 2), h), (mods["skip"](xs[1], xs[2], h // 2), h)]


def fusion_cotangent(i, k, shape):
    """The whole cotangent of case ``i``'s output ``k``."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(20000 + 100 * i + k))


def _fusion(S, i, rank):
    """Case ``i`` on this rank's bands under the active layout, in float64
    (so that only the layout's logic can part it from the whole module: a
    scalar parameter's gradient sums ~10⁴ products, which fp32 rounds by
    1e-5 of the sum): the outputs gathered whole and the layout's counts;
    then the backward of the sum over the outputs of <this rank's share of
    the cotangent, output> (a banded output's band; the whole of a
    replicated one on rank 0, nothing on the others), the inputs'
    gradients (bands, or the whole tensor where its level is not banded)
    and the parameters'."""
    mods, inputs = fusion_case(i)
    mods = mods.double()
    xs = [S.band_rows(x.double()).clone().requires_grad_() for x, _ in inputs]
    S.current().reset_counts()
    outs = fusion_forward(i, mods, xs, inputs[0][1])
    counts = dict(S.current().counts)
    total = 0
    gathered = []
    for k, (y, h) in enumerate(outs):
        whole = S.gather_rows(y.detach(), h)
        gathered.append(whole)
        cot = fusion_cotangent(i, k, whole.shape).double()
        share = S.band_rows(cot) if S.banded(h) else (cot if rank == 0 else torch.zeros_like(cot))
        total = total + (y * share).sum()
    total.backward()
    return {"outs": gathered, "grads": [x.grad for x in xs], "counts": counts,
            "params": {n: p.grad for n, p in mods.named_parameters() if p.grad is not None}}
