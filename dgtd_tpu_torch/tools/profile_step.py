"""Where a served batch's or a train step's time goes on the GPU
(counterpart of ``dgtd_tpu/tools/profile_step.py``).

Builds full-width ``cod`` from a seed and runs a few served batches of random
inputs through ``model.predict`` or, with ``--train``, a few train steps
(``configs/cod.yml``'s optimizer, drop-path on) on one synthetic batch, and
prints, from one ``torch.profiler`` trace of ``--iters`` of them:
  * host time to enqueue one batch or step (after a synchronise) against
    the device's busy time a batch or step (host-bound if close);
  * each program span (``core/trace.py``: ``dgtd.train.*``,
    ``dgtd.predict``, ``dgtd.prompt_encoder``, ``dgtd.prompt_decoders``,
    ``dgtd.backbone``, ``dgtd.decode``, ``dgtd.loss``): its host ms, the
    device ms of the operations launched inside it on any thread (by
    correlation id: the backward's kernels are launched from autograd's
    thread), the device's idle ms inside it and its kernel launches;
  * the device's busy share of the window (the union of the device's
    operations, overlaps counted once) and the top kernels by device time.

    python -m dgtd_tpu_torch.tools.profile_step [--train] [--batch 8|10] [--size 384] [--grid 12|64] [--fp32] [--iters 10]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import torch

from ..core.config import load_config
from ..core.device import resolve_device
from ..models.cod import cod
from ..train.optim import Optimizer
from ..train.state import train_step

RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "cod.yml")

#: runtime calls that launch a kernel (CUDA runtime and driver API)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchCooperativeKernel")
#: device-side spans of host ranges, which the trace lists beside the kernels
ANNOTATIONS = ("dgtd.", "Optimizer.", "ProfilerStep")


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("stencil_fused_fwd", "diffusion stencil (ours)"), ("stencil_step", "diffusion stencil (ours)"),
                     ("stencil_cluster_fwd", "diffusion stencil (ours)"), ("stencil_tiled_fwd", "diffusion stencil (ours)"),
                     ("stencil_fused_bwd", "diffusion stencil backward (ours)"),
                     ("stencil_cluster_bwd", "diffusion stencil backward (ours)"),
                     ("stencil_tiled_bwd", "diffusion stencil backward (ours)"),
                     ("stencil_bwd", "diffusion stencil backward (ours)"),
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


def _union(ivs) -> List[Tuple[float, float]]:
    """Sorted intervals with overlaps merged."""
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def _overlap(ivs, merged) -> float:
    """Length of ``merged`` (sorted, disjoint) that lies inside ``ivs``."""
    ends = [b for _, b in merged]
    total = 0.0
    for a, b in ivs:
        i = bisect.bisect_right(ends, a)
        while i < len(merged) and merged[i][0] < b:
            total += min(b, merged[i][1]) - max(a, merged[i][0])
            i += 1
    return total


def _is_launch(name: str) -> bool:
    return name.split("_v")[0] in KERNEL_LAUNCHES


def _puts_work(name: str) -> bool:
    return "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))


def profile_spans(run: Callable[[], None], iters: int, cuda: bool = True) -> Dict:
    """Profile ``iters`` calls of ``run`` and reduce the trace: the window
    and the device's busy time (ms, the union of its operations), the
    kernels, and a row per program span, outer spans first (ms and counts
    a call of ``run``): ``calls``, ``host_ms``, ``device_ms`` (the
    operations whose launching runtime call starts inside the span, on any
    thread, united), ``idle_ms`` (the span's host intervals less the
    device's busy time over them) and ``launches``. The device columns are
    0 without ``cuda``."""
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        if cuda:
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == device and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(ANNOTATIONS)]
    host = [e for e in events if e.device_type != device]
    busy = _union((e.time_range.start, e.time_range.end) for e in kernels)
    calls = sorted((e.time_range.start, e.name, e.id) for e in host if _puts_work(e.name))
    call_starts = [c[0] for c in calls]
    by_span: Dict[str, list] = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.name.startswith("dgtd."):
            by_span.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    rows = []
    for name, ivs in by_span.items():
        merged = _union(ivs)
        inside = []
        for a, b in merged:
            i = bisect.bisect_left(call_starts, a)
            while i < len(calls) and calls[i][0] <= b:
                inside.append(calls[i])
                i += 1
        corrs = {c[2] for c in inside}
        device_us = _length(_union((k.time_range.start, k.time_range.end) for k in kernels if k.id in corrs))
        idle_us = _length(merged) - _overlap(merged, busy) if cuda else 0.0
        rows.append({"span": name, "calls": len(ivs) / iters, "host_ms": _length(ivs) / 1e3 / iters,
                     "device_ms": device_us / 1e3 / iters, "idle_ms": idle_us / 1e3 / iters,
                     "launches": sum(1 for c in inside if _is_launch(c[1])) / iters})
    return {"window_ms": window_ms, "busy_ms": _length(busy) / 1e3, "iters": iters, "kernels": kernels,
            "spans": rows}


def span_lines(report: Dict, what: str) -> List[str]:
    """The span table of :func:`profile_spans`, a line a span."""
    lines = [f"program spans (a {what}; device ms of the operations launched inside each, any thread, united; "
             f"idle: the device's idle time inside the span's host intervals):",
             f"  {'span':24s} {'calls':>6s} {'host ms':>10s} {'device ms':>10s} {'idle ms':>10s} {'launches':>9s}"]
    for r in report["spans"]:
        lines.append(f"  {r['span']:24s} {r['calls']:6.1f} {r['host_ms']:10.3f} {r['device_ms']:10.3f} "
                     f"{r['idle_ms']:10.3f} {r['launches']:9.1f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="profile train steps instead of served batches")
    ap.add_argument("--batch", type=int, default=None, help="default: 8 served, 10 (the recipe's) in training")
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--grid", type=int, default=12, help="the diffusion grid (the paper's ablation: 4 ... 64)")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    args.batch = args.batch or (10 if args.train else 8)
    dev = resolve_device("cuda")
    what = "step" if args.train else "batch"

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    model = cod(dtype=torch.float32 if args.fp32 else torch.bfloat16, seed=0, grid=args.grid).to(dev)
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

    # host enqueue of one batch or step, begun after a synchronise
    host = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host_ms = statistics.median(host)

    report = profile_spans(run, args.iters)
    kernels, window_ms, busy_ms = report["kernels"], report["window_ms"], report["busy_ms"]
    per = busy_ms / args.iters
    print(f"{'train step' if args.train else 'served batch'}, batch {args.batch} at {args.size}², grid {args.grid}, "
          f"{'fp32' if args.fp32 else 'bf16'}: device busy {per:.3f} ms per {what} (union of its operations, "
          f"{args.iters} {what}s), host enqueue {host_ms:.3f} ms (median, {host_ms / per:.0%} of it)")
    print(f"profiler window {window_ms:.3f} ms for {args.iters} {what}s; kernels {len(kernels)} "
          f"({len(kernels) / args.iters:.0f} per {what}), device busy {busy_ms:.3f} ms "
          f"({busy_ms / window_ms:.0%}; idle {1 - busy_ms / window_ms:.0%})")
    for line in span_lines(report, what):
        print(line)
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
