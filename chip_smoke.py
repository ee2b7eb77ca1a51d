#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     kernel of the served and trained paths from ``dgtd_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  2. hold the diffusion-stencil kernel against its plain PyTorch version
     (k in {1, 3, 7}; 12x12, 13x20, 64x64; P = 192 planes; fp32 and bf16);
  3. serve full-width ``cod`` (PVTv2-b2 + ConvNeXt-B, seeded random weights)
     at 384², batch 8, through ``dgtd_tpu_torch.predict.main`` with a saved
     ``.pth``: once in bf16, once with ``--fp32``. The kernel's launch count
     is reset just before each run and read just after; masks are checked,
     bf16 is held to fp32, and the fp32 model on the card to the same model
     on the CPU on a small input;
  4. re-check the kernel against the plain version on the exact
     ``MessagePassing`` inputs captured during phase 3;
  5. time the kernel, its plain version and served batches with CUDA events;
  6. hold the stencil's backward kernel against the plain backward (the same
     cases at P = 240, fp32 and bf16) and the autograd Function's 4-step
     backward against autograd through the plain forward;
  7. tiny ``cod``: loss and every parameter gradient, fp32 on the card (TF32
     off) against the CPU, same weights and inputs, drop-path rates 0;
  8. train full-width ``cod`` through ``dgtd_tpu_torch.train.cli.main`` with
     ``configs/cod.yml`` (384², batch 10, bf16 autocast) on 30 synthetic
     images for 2 epochs (6 steps): finite losses, both kernels' launch
     counts, two epoch checkpoints, the second served through
     ``predict.main``; one fp32 first step held to the bf16 one; the backward
     kernel re-checked on the stencil inputs and upstream gradient captured
     in a train step;
  9. time train steps back to back (bf16 and fp32), the CLI loop, peak
     memory, and the backward kernel against its bound and its plain version.

Prints a ``kernels`` JSON line, a served-throughput line and a ``trained``
JSON line, each with the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL, STEPS, P_MAIN = 7, 4, 8 * 24  # served stencil: k=7, 4 steps, B·C planes
SHAPES = [(k, hw) for k in (1, 3, 7) for hw in ((12, 12), (13, 20), (64, 64))]
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 1e-2  # per-step bf16 rounding of O(1) convex combinations
MEAN_ATOL = 2e-3  # bf16 vs fp32 mean probability (tests/test_golden_forward.py)
CPU_PROB_ATOL = 1e-3  # fp32 card vs fp32 CPU, TF32 off, full-width model
N_IMAGES, BATCH, SIZE = 20, 8, 384  # 3 batches, the last padded from 4
P_TRAIN = 10 * 24  # train stencil: batch 10 x 24 latent channels
# backward, fp32: dx is a 49-term sum in another order than F.fold's, dw an
# exact product (one step) or a 4-term sum
BWD_FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# backward, bf16: both sides sum in fp32 and round to bf16, so a rounding
# can flip one ulp (2^-7 relative); the chains also round dx after each step
BWD_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
# autograd through the plain bf16 forward rounds dw after every step (4
# roundings of the partial sums) where the kernel rounds once
AUTOGRAD_BF16_TOL = dict(rtol=3.2e-2, atol=1e-2)
# tiny cod, fp32 card (TF32 off) vs CPU: the loss to 1e-5, each gradient to
# 1e-3 of its largest entry (cuDNN and MKL sum in other orders; the CPU port
# agrees with the JAX package to ~1e-5 of each gradient's scale)
TINY_LOSS_RTOL, TINY_GRAD_RTOL = 1e-5, 1e-3
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2, drop_path_rate=0.0, convnext_drop_path_rate=0.0)
# full-width training run: 30 images, the recipe's batch 10, 2 epochs
TRAIN_N, TRAIN_BATCH, TRAIN_EPOCHS = 30, 10, 2
TRAIN_STEPS = TRAIN_EPOCHS * (TRAIN_N // TRAIN_BATCH)
# bf16 autocast vs fp32 first-step loss (same weights, batch, drop-path
# masks): the served bf16 mean probability moved 5e-5 from fp32, the loss
# sums ~6 such terms; 1e-2 relative leaves room for the logits' bf16 error
FIRST_LOSS_RTOL = 1e-2
# H100 SXM peaks: HBM bytes/s; fp32 non-tensor FLOP/s
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12


def say(*parts):
    print(*parts, flush=True)


def check(ok, what):
    """A failed check ends the run with a non-zero exit (not ``assert``,
    which ``python -O`` would drop)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_time_ms(fn, iters, warmup=10):
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stencil_bound(x, w, kernel, steps):
    """Least time (ms) for ``steps`` stencil steps on these inputs: x and w
    read once, the output written once, over HBM; 2 flops per weight per step
    over the fp32 rate (the kernel accumulates in fp32 on the CUDA cores)."""
    nbytes = (2 * x.numel() + w.numel()) * x.element_size()
    flops = 2.0 * w.numel() * steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(D, x, w, kernel, steps, label):
    """Kernel vs plain on the same inputs; returns the max abs error."""
    import torch

    out = D.diffusion_planes(x, w, kernel, steps)
    torch.cuda.synchronize()
    if x.dtype == torch.float32:
        ref = D.diffusion_planes_plain(x, w, kernel, steps)
        torch.testing.assert_close(out, ref, **FP32_TOL, msg=lambda m: f"{label}: {m}")
    else:
        ref = D.diffusion_planes_plain(x.float(), w.float(), kernel, steps)
        out = out.float()
        torch.testing.assert_close(out, ref, rtol=0, atol=BF16_ATOL, msg=lambda m: f"{label}: {m}")
    err = float((out - ref).abs().max())
    say(f"  {label}: max_abs_err={err:.3e}")
    return err


def stencil_bwd_bound(g, xs, w, kernel):
    """Least time (ms) for the backward of ``len(xs)`` steps on these inputs:
    g, the step inputs and w read once, dx and dw written once, over HBM;
    against the flops: 2 per in-plane tap for dx, 1 per in-plane tap for
    dw's product, and the k²·H·W adds per plane of each cross-step sum, over
    the fp32 rate (the kernel computes in fp32 on the CUDA cores)."""
    p, h, wd = g.shape
    r, steps = kernel // 2, len(xs)
    taps = sum(max(h - abs(d - r), 0) for d in range(kernel)) * sum(max(wd - abs(d - r), 0) for d in range(kernel))
    nbytes = ((2 + steps) * g.numel() + 2 * w.numel()) * g.element_size()
    flops = p * (3.0 * taps * steps + (steps - 1) * kernel * kernel * h * wd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_inputs(D, x, w, kernel, steps):
    """The inputs of ``steps`` stencil steps from x (plain forward)."""
    xs = [x]
    for _ in range(steps - 1):
        xs.append(D.diffusion_step_plain(xs[-1], w, kernel))
    return xs


def check_bwd(D, g, xs, w, kernel, label):
    """Backward kernel vs plain backward on the same inputs; returns the max
    abs error over dx and dw."""
    import torch

    dx, dw = D.diffusion_planes_bwd(g, xs, w, kernel)
    torch.cuda.synchronize()
    rdx, rdw = D.diffusion_planes_bwd_plain(g, xs, w, kernel)
    check(dx.dtype == g.dtype and dw.dtype == w.dtype, f"{label}: dtypes {dx.dtype} {dw.dtype}")
    tol = BWD_FP32_TOL if g.dtype == torch.float32 else BWD_BF16_TOL
    err = 0.0
    for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
        torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((got.float() - ref.float()).abs().max()))
    say(f"  {label}: max_abs_err={err:.3e}")
    return err


def write_inputs(root, n=N_IMAGES):
    from PIL import Image

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "dep"))
    for i in range(n):
        # smooth random scenes: coarse noise upsampled, plus fine noise
        coarse = (rng.rand(6, 6, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((SIZE, SIZE), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.randn(SIZE, SIZE, 3) * 12, 0, 255).astype(np.uint8)
        dep = np.asarray(Image.fromarray(coarse[..., 0]).resize((SIZE, SIZE), Image.BILINEAR))
        Image.fromarray(img).save(os.path.join(root, "img", f"scene{i:02d}.png"))
        Image.fromarray(dep).save(os.path.join(root, "dep", f"scene{i:02d}_depth.png"))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from PIL import Image

    from dgtd_tpu_torch import predict as P
    from dgtd_tpu_torch.models import diffusion as MD
    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.ops import _build
    from dgtd_tpu_torch.ops import diffusion as D

    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    # ---- 1. card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x{count}")
    t0 = time.perf_counter()
    sources = ["diffusion_stencil", "diffusion_stencil_bwd"]
    _build.build(sources)
    say(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "ptxas" in line:
                say(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("phase 2: kernel vs plain (P=192, 4 steps)")
    g = torch.Generator(device=dev).manual_seed(0)
    for k, (h, w) in SHAPES:
        x = torch.rand(P_MAIN, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(P_MAIN, k * k, h, w, generator=g, device=dev), dim=1)
        check_kernel(D, x, wt, k, STEPS, f"fp32 k={k} {h}x{w}")
        check_kernel(D, x.bfloat16(), wt.bfloat16(), k, STEPS, f"bf16 k={k} {h}x{w}")

    # ---- 3. the served path ----
    say(f"phase 3: serve full-width cod at {SIZE}², batch {BATCH}, {N_IMAGES} images")
    captured = {}
    run = {"name": None}
    probs = {}

    def capture(module, inputs, output):
        if isinstance(module, MD.MessagePassing) and run["name"] not in captured:
            captured[run["name"]] = (inputs[0].detach().clone(), inputs[1].detach().clone())

    predict_unspied = cod.predict

    def spy_predict(self, image, depth, out_size=None):
        out = predict_unspied(self, image, depth, out_size)
        probs.setdefault(run["name"], []).append(out[0])
        return out

    summaries, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model = cod(seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt = os.path.join(tmp, "cod_seed0.pth")
        torch.save(model.state_dict(), ckpt)
        write_inputs(tmp)
        say(f"  cod: {n_params} parameters, seeded init saved to a .pth")
        hook = torch.nn.modules.module.register_module_forward_hook(capture)
        cod.predict = spy_predict
        try:
            for name, extra in (("bf16", []), ("fp32", ["--fp32"])):
                out_dir = os.path.join(tmp, f"out_{name}")
                argv = ["--checkpoint", ckpt, "--image-dir", os.path.join(tmp, "img"),
                        "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", out_dir,
                        "--size", str(SIZE), "--batch", str(BATCH)] + extra
                run["name"] = name
                D.LAUNCHES = 0
                summaries[name] = P.main(argv)
                launches[name] = D.LAUNCHES
                torch.cuda.synchronize()
                nb = summaries[name]["batches"]
                say(f"  {name}: {summaries[name]['images']} images in {nb} batches, "
                    f"loop {summaries[name]['loop_s']:.3f} s, stencil launches {launches[name]}")
                check(launches[name] == STEPS * nb, (name, launches[name], nb))
                outs = sorted(os.listdir(out_dir))
                check(len(outs) == N_IMAGES and all(f.endswith("_output.png") for f in outs), outs)
                for f in outs:
                    with Image.open(os.path.join(out_dir, f)) as im:
                        check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        finally:
            cod.predict = predict_unspied
            hook.remove()

    means = {}
    for name, chunks in probs.items():
        p = torch.cat(chunks)[:N_IMAGES].float()
        check(p.shape == (N_IMAGES, SIZE, SIZE, 1), p.shape)
        check(bool(torch.isfinite(p).all()) and float(p.min()) >= 0 and float(p.max()) <= 1, name)
        means[name] = float(p.mean())
    gap = abs(means["bf16"] - means["fp32"])
    say(f"  mean probability bf16 {means['bf16']:.6f} fp32 {means['fp32']:.6f} |diff| {gap:.2e} (limit {MEAN_ATOL})")
    check(gap <= MEAN_ATOL, f"bf16 vs fp32 mean probability {gap:.2e} > {MEAN_ATOL}")

    # fp32 on the card vs the same weights on the CPU (plain stencil), small input
    g_cpu = torch.Generator().manual_seed(1)
    img = torch.randn(1, 192, 192, 3, generator=g_cpu)
    depth = torch.rand(1, 192, 192, 1, generator=g_cpu)
    model32 = cod(dtype=torch.float32, seed=0)
    ref = model32.predict(img, depth)[0]
    got = model32.to(dev).predict(img.to(dev), depth.to(dev))[0].cpu()
    cpu_err = float((got - ref).abs().max())
    say(f"  fp32 card vs CPU, 1x192x192: max_abs_err {cpu_err:.3e} (limit {CPU_PROB_ATOL})")
    check(cpu_err <= CPU_PROB_ATOL, f"card vs CPU {cpu_err:.2e} > {CPU_PROB_ATOL}")

    # ---- 4. kernel vs plain on the served path's own tensors ----
    say("phase 4: kernel vs plain on captured MessagePassing inputs")
    served = {}
    for name in ("bf16", "fp32"):
        x, weight = captured[name]
        xp, wt = MD.affinity_planes(x, weight, KERNEL)
        check(tuple(xp.shape) == (P_MAIN, 12, 12), xp.shape)
        say(f"  {name} run: x {tuple(xp.shape)} {xp.dtype}, w {tuple(wt.shape)} {wt.dtype}")
        served[name] = (xp, wt, check_kernel(D, xp, wt, KERNEL, STEPS, f"served {name}"))
    check(served["bf16"][0].dtype == torch.bfloat16 and served["fp32"][0].dtype == torch.float32,
          "the bf16 run's stencil ran in bf16 and the fp32 run's in fp32")

    # ---- 5. timings ----
    say("phase 5: timings (CUDA events)")
    rows = {}
    for name in ("bf16", "fp32"):
        xp, wt, err = served[name]
        ms = cuda_time_ms(lambda: D.diffusion_planes(xp, wt, KERNEL, STEPS), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_plain(xp, wt, KERNEL, STEPS), 200)
        bound_ms, bound_by = stencil_bound(xp, wt, KERNEL, STEPS)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)
        say(f"  stencil {name} ({STEPS} steps, {P_MAIN}x12x12, k={KERNEL}): kernel {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")

    model.to(dev)
    g_dev = torch.Generator(device=dev).manual_seed(2)
    img = torch.randn(BATCH, SIZE, SIZE, 3, generator=g_dev, device=dev)
    depth = torch.rand(BATCH, SIZE, SIZE, 1, generator=g_dev, device=dev)
    served_ms = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model.dtype = dtype
        served_ms[name] = cuda_time_ms(lambda: model.predict(img, depth), 20, warmup=3)
    say(f"served: cod bf16 {served_ms['bf16']:.3f} ms/batch, {BATCH * 1e3 / served_ms['bf16']:.2f} images/s; "
        f"fp32 {served_ms['fp32']:.3f} ms/batch, {BATCH * 1e3 / served_ms['fp32']:.2f} images/s "
        f"(batch {BATCH}, {SIZE}², model.predict back to back) [{card}]")

    # ---- 6. backward kernel vs plain backward ----
    say(f"phase 6: backward kernel vs plain backward (P={P_TRAIN})")
    for k, (h, w) in SHAPES:
        x = torch.rand(P_TRAIN, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(P_TRAIN, k * k, h, w, generator=g, device=dev), dim=1)
        gr = torch.rand(P_TRAIN, h, w, generator=g, device=dev)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xd, wd, gd = x.to(dt), wt.to(dt), gr.to(dt)
            check_bwd(D, gd, [xd], wd, k, f"{name} k={k} {h}x{w}, 1 step")
            check_bwd(D, gd, step_inputs(D, xd, wd, k, STEPS), wd, k, f"{name} k={k} {h}x{w}, {STEPS} steps")
    for name, dt, tol in (("fp32", torch.float32, BWD_FP32_TOL), ("bf16", torch.bfloat16, AUTOGRAD_BF16_TOL)):
        x = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev).to(dt)
        wt = MD.normalize_affinity(torch.rand(P_TRAIN, KERNEL ** 2, 12, 12, generator=g, device=dev), dim=1).to(dt)
        gout = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev).to(dt)
        xa, wa = x.clone().requires_grad_(), wt.clone().requires_grad_()
        xb, wb = x.clone().requires_grad_(), wt.clone().requires_grad_()
        before = (D.LAUNCHES, D.BWD_LAUNCHES)
        D.diffusion_planes(xa, wa, KERNEL, STEPS).backward(gout)
        torch.cuda.synchronize()
        check((D.LAUNCHES, D.BWD_LAUNCHES) == (before[0] + STEPS, before[1] + STEPS),
              f"Function {name}: launches {before} -> {(D.LAUNCHES, D.BWD_LAUNCHES)}")
        D.diffusion_planes_plain(xb, wb, KERNEL, STEPS).backward(gout)
        err = 0.0
        for gname, got, ref in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"Function {name} {gname}: {m}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        say(f"  Function {name}, {STEPS} steps, vs autograd through the plain forward: max_abs_err={err:.3e}")

    # ---- 7. tiny cod: loss and gradients, card vs CPU ----
    say("phase 7: tiny cod loss and every parameter gradient, fp32 card (TF32 off) vs CPU")
    import copy

    m_cpu = cod(dtype=torch.float32, seed=0, **TINY)
    m_dev = copy.deepcopy(m_cpu).to(dev)
    rng = np.random.RandomState(5)
    inputs = [torch.from_numpy(a) for a in (
        rng.randn(2, 64, 64, 3).astype(np.float32), rng.rand(2, 64, 64, 1).astype(np.float32),
        (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32))]
    loss_cpu = m_cpu.loss(*inputs)[0]
    loss_cpu.backward()
    loss_dev = m_dev.loss(*[t.to(dev) for t in inputs])[0]
    loss_dev.backward()
    loss_cpu, loss_dev = loss_cpu.item(), loss_dev.item()
    check(abs(loss_dev - loss_cpu) <= TINY_LOSS_RTOL * abs(loss_cpu), f"tiny loss card {loss_dev} vs CPU {loss_cpu}")
    grads_cpu = dict(m_cpu.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in grads_cpu.values())
    worst = (0.0, "")
    for n, p in m_dev.named_parameters():
        ref = grads_cpu[n].grad
        diff = float((p.grad.cpu() - ref).abs().max())
        limit = TINY_GRAD_RTOL * max(float(ref.abs().max()), 1e-4 * scale)
        check(diff <= limit, f"gradient of {n}: card vs CPU {diff:.3e} > {limit:.3e}")
        worst = max(worst, (diff / limit, n))
    say(f"  loss card {loss_dev:.7f} CPU {loss_cpu:.7f}; {len(grads_cpu)} gradients within "
        f"{TINY_GRAD_RTOL} of their scale (closest to its limit: {worst[1]} at {worst[0]:.3f} of it)")
    del m_cpu, m_dev

    # ---- 8. full-width training through the train CLI ----
    say(f"phase 8: train full-width cod through dgtd_tpu_torch.train.cli.main: configs/cod.yml, "
        f"{TRAIN_N} images at {SIZE}², batch {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs, bf16")
    from dgtd_tpu_torch.core.config import load_config
    from dgtd_tpu_torch.train import cli as TC
    from dgtd_tpu_torch.train.loop import Runner
    from dgtd_tpu_torch.train.state import train_step

    model.cpu()
    del model
    torch.cuda.empty_cache()
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    grab = {}
    planes_unspied = MD.diffusion_planes

    def spy_planes(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        if "x" not in grab and out.requires_grad:
            grab["x"], grab["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab.setdefault("g", gr.detach().clone()))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        work = os.path.join(tmp, "run")
        overrides = [
            f"work_dir={work}", f"train_cfg.max_epochs={TRAIN_EPOCHS}", "train_cfg.val_interval=0",
            f"train_dataloader.batch_size={TRAIN_BATCH}",
            f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {TRAIN_N}, 'size': {SIZE}}}",
            "default_hooks.logger.interval=1", "default_hooks.checkpoint.interval=1",
        ]
        argv = [recipe] + [a for o in overrides for a in ("-o", o)]
        MD.diffusion_planes = spy_planes
        try:
            torch.cuda.reset_peak_memory_stats()
            D.LAUNCHES = D.BWD_LAUNCHES = 0
            trained = TC.main(argv)
            fwd_launches, bwd_launches = D.LAUNCHES, D.BWD_LAUNCHES
            cli_peak = torch.cuda.max_memory_allocated()
        finally:
            MD.diffusion_planes = planes_unspied
        say(f"  {trained['steps']} steps in {trained['loop_s']:.3f} s; stencil launches: forward {fwd_launches}, "
            f"backward {bwd_launches}; peak memory {cli_peak / 2**30:.3f} GiB")
        check(trained["steps"] == TRAIN_STEPS, trained)
        check(fwd_launches == STEPS * TRAIN_STEPS, f"forward launches {fwd_launches} != {STEPS}x{TRAIN_STEPS}")
        check(bwd_launches == STEPS * 1 * TRAIN_STEPS, f"backward launches {bwd_launches} != {STEPS}x1x{TRAIN_STEPS}")
        with open(os.path.join(work, "log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r for r in records if "loss" in r]
        check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss records")
        check(all(np.isfinite([r["loss"], r["loss_seg"], r["loss_ssim"]]).all() for r in losses), losses)
        say("  losses: " + ", ".join(f"{r['loss']:.5f}" for r in losses))
        ckpts = [os.path.join(work, f"epoch_{e}.pth") for e in range(1, TRAIN_EPOCHS + 1)]
        check(all(os.path.exists(c) for c in ckpts), ckpts)
        loaded, missed, unused = P.load_checkpoint(cod(seed=None), ckpts[-1])
        check(not missed and not unused, f"epoch-{TRAIN_EPOCHS} checkpoint: missed {missed[:3]} unused {unused[:3]}")

        serve = os.path.join(tmp, "serve")
        write_inputs(serve, TRAIN_BATCH)
        out_dir = os.path.join(serve, "out")
        D.LAUNCHES = 0
        P.main(["--checkpoint", ckpts[-1], "--image-dir", os.path.join(serve, "img"),
                "--depth-dir", os.path.join(serve, "dep"), "--out-dir", out_dir,
                "--size", str(SIZE), "--batch", str(TRAIN_BATCH)])
        check(D.LAUNCHES == STEPS, f"serving the trained checkpoint: {D.LAUNCHES} launches")
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == TRAIN_BATCH, outs)
        for f in outs:
            with Image.open(os.path.join(out_dir, f)) as im:
                check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        say(f"  epoch-{TRAIN_EPOCHS} checkpoint ({len(loaded)} keys) served {len(outs)} masks")

        # one fp32 first step: same seed, weights, first batch, drop-path masks
        runner = Runner(load_config(recipe, overrides[1:]), work_dir=os.path.join(tmp, "fp32"), seed=0,
                        device=dev, dtype=torch.float32)
        first = next(iter(runner.train_loader))
        batch = {k: first[k] for k in ("input", "label", "depth")}
        loss32 = float(train_step(runner.model, runner.optimizer, batch, 0, runner.seed + 1)["loss"])
        loss16 = losses[0]["loss"]
        rel = abs(loss16 - loss32) / abs(loss32)
        say(f"  first-step loss bf16 {loss16:.5f} fp32 {loss32:.7f} (relative {rel:.2e}, limit {FIRST_LOSS_RTOL})")
        check(rel <= FIRST_LOSS_RTOL, f"bf16 vs fp32 first-step loss {rel:.2e} > {FIRST_LOSS_RTOL}")

    say("  backward kernel vs plain on the stencil inputs and gradient of a train step")
    gx, gw, gg = grab["x"], grab["w"], grab["g"]
    check(tuple(gx.shape) == (P_TRAIN, 12, 12) and gx.dtype == torch.bfloat16 and gg.dtype == torch.bfloat16,
          (gx.shape, gx.dtype, gg.dtype))
    gxs = step_inputs(D, gx, gw, KERNEL, STEPS)
    train_err = check_bwd(D, gg, gxs, gw, KERNEL, f"trained bf16, {STEPS} steps")
    train_err32 = check_bwd(D, gg.float(), [t.float() for t in gxs], gw.float(), KERNEL,
                            f"trained, as fp32, {STEPS} steps")

    # ---- 9. timings ----
    say("phase 9: train-step and backward-kernel timings (CUDA events)")
    bwd_rows = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        tg, txs, tw = gg.to(dt), [t.to(dt) for t in gxs], gw.to(dt)
        ms = cuda_time_ms(lambda: D.diffusion_planes_bwd(tg, txs, tw, KERNEL), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_bwd_plain(tg, txs, tw, KERNEL), 50)
        bound_ms, bound_by = stencil_bwd_bound(tg, txs, tw, KERNEL)
        bwd_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        say(f"  stencil backward {name} ({STEPS} steps, {P_TRAIN}x12x12, k={KERNEL}): kernel {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    bwd_rows["fp32"]["err"] = train_err32
    step_ms, peak = {}, {}
    counter = [1]

    def one_step():
        train_step(runner.model, runner.optimizer, batch, counter[0], runner.seed + 1)
        counter[0] += 1

    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        runner.model.dtype = dt
        torch.cuda.reset_peak_memory_stats()
        step_ms[name] = cuda_time_ms(one_step, 10, warmup=3)
        peak[name] = torch.cuda.max_memory_allocated()
        say(f"  train step {name}: {step_ms[name]:.3f} ms, {TRAIN_BATCH * 1e3 / step_ms[name]:.2f} images/s, "
            f"peak memory {peak[name] / 2**30:.3f} GiB (batch {TRAIN_BATCH}, {SIZE}², back to back) [{card}]")

    b = rows["bf16"]
    bb = bwd_rows["bf16"]
    say(json.dumps({"kernels": [{
        "name": "diffusion_stencil",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:263",
        "launches": launches["bf16"],
        "max_abs_err": b["err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"x ({P_MAIN},12,12), w ({P_MAIN},{KERNEL * KERNEL},12,12), {STEPS} steps",
        "launches_per_batch": launches["bf16"] // summaries["bf16"]["batches"],
        "launches_train": fwd_launches,
        "launches_per_step": fwd_launches // TRAIN_STEPS,
        "fp32": rows["fp32"],
        "card": card,
    }, {
        "name": "diffusion_stencil_bwd",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil_bwd.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:162",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches // TRAIN_STEPS,
        "max_abs_err": train_err,
        "ms": bb["ms"],
        "plain_ms": bb["plain_ms"],
        "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"g, x ({P_TRAIN},12,12), w, dw ({P_TRAIN},{KERNEL * KERNEL},12,12), {STEPS}-step backward",
        "fp32": bwd_rows["fp32"],
        "card": card,
    }]}))
    say(json.dumps({"trained": {
        "model": "cod, full width (PVTv2-b2, ConvNeXt-B), seeded random weights",
        "size": SIZE, "batch": TRAIN_BATCH,
        "step_ms": step_ms,
        "images_per_s": {k: TRAIN_BATCH * 1e3 / v for k, v in step_ms.items()},
        "peak_memory_bytes": peak,
        "cli_steps": trained["steps"],
        "cli_s_per_step": trained["loop_s"] / trained["steps"],
        "cli_peak_memory_bytes": cli_peak,
        "first_step_loss": {"bf16": loss16, "fp32": loss32},
        "card": card,
    }}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
