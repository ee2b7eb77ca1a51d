"""Where a served batch's or a train step's time goes on the GPU
(counterpart of ``dgtd_tpu/tools/profile_step.py``).

Builds full-width ``cod`` from a seed and runs a few served batches of random
inputs through ``model.predict`` or, with ``--train``, a few train steps
(``configs/cod.yml``'s optimizer, drop-path on) on one synthetic batch, and
prints:
  * host time to enqueue one batch or step vs its device time (host-bound if
    close);
  * device time per forward layer (CUDA events at module boundaries on the
    stream);
  * device busy share and the top kernels by device time (``torch.profiler``).

    python -m dgtd_tpu_torch.tools.profile_step [--train] [--batch 8|10] [--size 384] [--fp32] [--iters 10]
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time

import torch

from ..core.config import load_config
from ..core.device import resolve_device
from ..models.cod import cod
from ..train.optim import Optimizer
from ..train.state import train_step

RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "cod.yml")

#: layers timed by CUDA events: (label, module path under ``model.hitnet``)
LAYERS = [
    ("prompt_encoder: FFT, affinities, stencil", "backbone.prompt_encoder.message_passing"),
    ("prompt_encoder: ConvNeXt-B tower", "backbone.prompt_encoder.encoder2"),
    ("prompt_encoder (whole)", "backbone.prompt_encoder"),
    ("prompt_decoders (28)", "backbone.prompt_decoder"),
    ("PVTv2-b2 backbone", "backbone"),
    ("HitNet (whole forward)", ""),
]


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("stencil_step", "diffusion stencil (ours)"), ("stencil_bwd", "diffusion stencil backward (ours)"),
                     ("multi_tensor", "optimizer (foreach)"), ("dgrad", "conv backward"),
                     ("wgrad", "conv backward"), ("softmax", "softmax"),
                     ("layer_norm", "layer norm"), ("batch_norm", "batch norm"), ("bn_", "batch norm"),
                     ("fft", "fft"), ("im2col", "im2col"), ("upsample", "resize"),
                     ("conv", "conv"), ("gemm", "gemm/matmul"), ("sm90", "gemm/matmul"),
                     ("cutlass", "gemm/matmul"), ("elementwise", "elementwise"), ("reduce", "reduction"),
                     ("copy", "copy"), ("cat", "concat")):
        if key in n:
            return cat
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="profile train steps instead of served batches")
    ap.add_argument("--batch", type=int, default=None, help="default: 8 served, 10 (the recipe's) in training")
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    args.batch = args.batch or (10 if args.train else 8)
    dev = resolve_device("cuda")
    what = "step" if args.train else "batch"

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    model = cod(dtype=torch.float32 if args.fp32 else torch.bfloat16, seed=0).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn(args.batch, args.size, args.size, 3, generator=g, device=dev)
    depth = torch.rand(args.batch, args.size, args.size, 1, generator=g, device=dev)
    if args.train:
        label = (torch.rand(args.batch, args.size, args.size, 1, generator=g, device=dev) > 0.5).float()
        opt = Optimizer(model.named_parameters(), load_config(RECIPE)["optim_wrapper"], 100, 1000)
        batch = {"input": img, "depth": depth, "label": label}
        count = [0]

        def run():
            train_step(model, opt, batch, count[0], 1)
            count[0] += 1
    else:
        def run():
            model.predict(img, depth)

    for _ in range(3):
        run()
    torch.cuda.synchronize()

    # host enqueue vs device time of one batch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = []
    dev_ms = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    host_ms, batch_ms = sorted(host)[len(host) // 2], sorted(dev_ms)[len(dev_ms) // 2]
    print(f"{'train step' if args.train else 'served batch'}, batch {args.batch} at {args.size}², "
          f"{'fp32' if args.fp32 else 'bf16'}: {batch_ms:.3f} ms per {what} on the stream (median of {args.iters}), "
          f"host enqueue {host_ms:.3f} ms ({host_ms / batch_ms:.0%} of it)")

    # device time per layer: events around module forwards, on the stream
    spans = collections.defaultdict(list)
    handles = []
    for label, path in LAYERS:
        mod = model.hitnet.get_submodule(path) if path else model.hitnet
        ev = {}

        def pre(m, inp, ev=ev):
            ev["s"] = torch.cuda.Event(enable_timing=True)
            ev["s"].record()

        def post(m, inp, out, ev=ev, label=label):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans[label].append((ev["s"], e))

        if isinstance(mod, torch.nn.ModuleList):
            for sub in mod:
                handles += [sub.register_forward_pre_hook(pre), sub.register_forward_hook(post)]
        else:
            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    print(f"device time per forward layer (ms per {what}, mean; spans include any idle gaps):")
    for label, _ in LAYERS:
        total = sum(s.elapsed_time(e) for s, e in spans[label]) / args.iters
        print(f"  {label:45s} {total:9.3f}")

    # kernels by device time, and the device's busy share of the window
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device-side spans of annotations (e.g. "Optimizer.step#AdamW.step")
    # cover kernels that are also listed: count kernels only
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profiler window {window_ms:.3f} ms for {args.iters} {what}s; kernels {len(kernels)} "
          f"({len(kernels) / args.iters:.0f} per {what}), device busy {busy_ms:.3f} ms "
          f"({busy_ms / window_ms:.0%}; idle {1 - busy_ms / window_ms:.0%})")
    by_name = collections.Counter()
    by_cat = collections.Counter()
    for e in kernels:
        t = e.time_range.elapsed_us() / 1e3
        by_name[e.name] += t
        by_cat[_category(e.name)] += t
    print(f"device time by kernel category (ms per {what}):")
    for cat, t in by_cat.most_common():
        print(f"  {cat:28s} {t / args.iters:9.3f}  {t / busy_ms:6.1%}")
    print(f"top kernels (ms per {what}):")
    for name, t in by_name.most_common(15):
        print(f"  {t / args.iters:9.3f}  {name[:110]}")


if __name__ == "__main__":
    main()
