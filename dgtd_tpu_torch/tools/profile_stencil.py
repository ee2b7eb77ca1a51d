"""Where the tiled diffusion-stencil kernels' time goes on the GPU.

For each plane shape (by default (192, 96, 96), ``cod``'s stencil at grid 96
and batch 8, and ``dgtd_tpu/tools/serving_check.py``'s (24, 512, 512); k = 7,
bf16) it prints, from ``torch.profiler``'s device time:
  * the tiled forward and backward at 1, 2 and 4 steps, beside the per-step
    kernels on the same tensors;
  * a device copy of w (w read once and written once: the card's streaming
    rate on the same bytes);
  * the bytes of w the tiled kernels read at each step count (each tile's
    region of each step, from ``ops/diffusion.py::tiled_plan``) and the rate
    at which they read them.
One step reads w once per tile region; each further step reads its (smaller)
region of w again, from L2 or from memory: the growth of the time with the
step count against the growth of the bytes says what the later steps cost.

    python -m dgtd_tpu_torch.tools.profile_stencil [--shape P H W ...] [--kernel 7] [--fp32] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import diffusion as D


def _span(lo: int, hi: int, grow: int, n: int) -> int:
    return min(hi + grow, n) - max(lo - grow, 0)


def tiled_w_reads(h: int, w: int, kernel: int, steps: int, dtype: torch.dtype, bwd: bool) -> int:
    """Bytes of w one plane's tiles read in a call: forward, step t reads w
    on each tile's interior grown by (steps-1-t)·r; backward, the step
    whose input has the gradient on the interior grown by t·r reads w on it
    grown by (t+1)·r (the transpose's sources); all within the plane."""
    th, tw, _ = D.tiled_plan(h, w, kernel, steps, dtype, bwd)
    r, total = kernel // 2, 0
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            y1, x1 = min(y0 + th, h), min(x0 + tw, w)
            for t in range(steps):
                grow = (t + 1) * r if bwd else (steps - 1 - t) * r
                total += _span(y0, y1, grow, h) * _span(x0, x1, grow, w)
    return total * kernel * kernel * dtype.itemsize


def device_ms(fn, match: str, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if match in e.key)
    return us / 1e3 / iters


def profile_planes(p: int, h: int, w: int, kernel: int, dtype: torch.dtype, iters: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(p, h, w, generator=g, device="cuda").to(dtype)
    raw = torch.rand(p, kernel * kernel, h, w, generator=g, device="cuda")
    wt = (raw / raw.sum(1, keepdim=True)).to(dtype)
    del raw
    gr = torch.rand(p, h, w, generator=g, device="cuda").to(dtype)
    out = torch.empty_like(x)
    w_bytes = wt.numel() * wt.element_size()
    row = {"shape": [p, h, w], "kernel": kernel, "dtype": str(dtype).split(".")[-1], "w_bytes": w_bytes,
           "copy_w_ms": device_ms(lambda: wt.clone(), "", iters), "steps": {}}
    for steps in (1, 2, 4):
        _, xs = D._forward_steps(x, wt, kernel, steps, keep=True)
        step = {}
        for part, fn, match, per_step, step_match in (
            ("fwd", lambda: D._tiled_forward(x, wt, kernel, steps, None, out), "stencil_tiled_fwd",
             lambda: D._per_step_forward(x, wt, kernel, steps, None, out), "stencil_step_kernel"),
            ("bwd", lambda: D._tiled_backward(gr, xs, wt, kernel), "stencil_tiled_bwd",
             lambda: D._per_step_backward(gr, xs, wt, kernel), "stencil_bwd_kernel"),
        ):
            ms = device_ms(fn, match, iters)
            reads = p * tiled_w_reads(h, w, kernel, steps, dtype, part == "bwd")
            step[part] = {"ms": ms, "per_step_ms": device_ms(per_step, step_match, iters),
                          "plan": D.tiled_plan(h, w, kernel, steps, dtype, part == "bwd"),
                          "w_read_bytes": reads, "w_read_tb_per_s": reads / ms / 1e9}
        row["steps"][steps] = step
        del xs
    row["copy_w_tb_per_s"] = 2 * w_bytes / row["copy_w_ms"] / 1e9
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, action="append", metavar=("P", "H", "W"),
                    help="planes to profile (repeatable); default (192, 96, 96) and (24, 512, 512)")
    ap.add_argument("--kernel", type=int, default=7)
    ap.add_argument("--fp32", action="store_true", help="fp32 tensors (default bf16)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stencil needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    rows = []
    for p, h, w in args.shape or [(192, 96, 96), (24, 512, 512)]:
        if D.plane_route(h, w, args.kernel, dtype, 4) != "tiled":
            raise SystemExit(f"({h}, {w}) at k={args.kernel} does not take the tiled kernels")
        row = profile_planes(p, h, w, args.kernel, dtype, args.iters)
        rows.append(row)
        print(f"({p},{h},{w}) k={args.kernel} {row['dtype']}: w {row['w_bytes'] / 1e6:.1f} MB, copy of w "
              f"{row['copy_w_ms']:.4f} ms ({row['copy_w_tb_per_s']:.2f} TB/s read+write) [{card}]")
        for steps, step in row["steps"].items():
            for part, v in step.items():
                print(f"  {part} {steps} step{'s' if steps > 1 else ''}: tiled {v['ms']:.4f} ms (tiles {v['plan']}), "
                      f"per-step kernels {v['per_step_ms']:.4f} ms; tiles read {v['w_read_bytes'] / 1e6:.1f} MB of w "
                      f"at {v['w_read_tb_per_s']:.2f} TB/s")
        torch.cuda.empty_cache()
    summary = {"profile_stencil": rows, "card": card}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
