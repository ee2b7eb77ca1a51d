#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     kernel of the served path from ``dgtd_tpu_torch/csrc``;
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
  5. time the kernel, its plain version and served batches with CUDA events.

Prints a ``kernels`` JSON line and a served-throughput line, each with the
card's name and power limit; the last line is
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


def write_inputs(root):
    from PIL import Image

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "dep"))
    for i in range(N_IMAGES):
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
    _build.build(["diffusion_stencil"])
    say(f"built diffusion_stencil in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("diffusion_stencil", "").splitlines():
        if "ptxas" in line:
            say(f"  {line.strip()}")

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

    b = rows["bf16"]
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
        "fp32": rows["fp32"],
        "card": card,
    }]}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
