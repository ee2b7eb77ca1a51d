"""The high-resolution serving path on the card (counterpart of
``dgtd_tpu/tools/serving_check.py``). Each check prints one JSON line:

  1. full-width ``cod`` predict in bf16 at batch 1, at each of ``--sizes``
     (704² and 1024²): ms an image (CUDA events, a distinct input each
     iteration), the stencil launches by kernel;
  2. the diffusion block at a ``--grid``² grid (C = 24, k = 7, 4 steps, bf16,
     inputs made on the device, one resident k²-field a layout): the plain
     PyTorch version on NHWC (``plain_torch_ms``), the transposes of the JAX
     ``diffusion_pallas_v2`` around ``ops/diffusion.py::diffusion_planes``
     (``nhwc_wrapper_ms``), and ``diffusion_planes`` on plane tensors
     (``planes_ms``; at 512² the tiled kernel). Each kernel leg is held to
     the plain leg at the stencil's bar.

    python -m dgtd_tpu_torch.tools.serving_check [--sizes 704 1024] [--grid 512] \\
        [--skip-predict] [--skip-diffusion] [--device cpu]

Exits non-zero when a kernel leg disagrees with the plain one; a kernel
leg that raises propagates. Only the plain leg may run out of memory (an
unfold of a k²-sized field), and that is reported as its result. Runs on
CUDA unless ``--device`` names another device (a missing card raises); on
the CPU every leg is the plain version, timed on the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops import diffusion as D

#: stencil kernel launch counters, reported as deltas around each check
LAUNCH_COUNTERS = ("FUSED_LAUNCHES", "CLUSTER_LAUNCHES", "TILED_LAUNCHES", "LAUNCHES")


def _launches() -> Dict[str, int]:
    return {name: getattr(D, name) for name in LAUNCH_COUNTERS}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def stencil_tolerance(dtype: torch.dtype, steps: int) -> Dict[str, float]:
    """The stencil's bars against its plain version: fp32 1e-5 relative and
    1e-6 absolute; bf16 absolute max(1e-2, steps·2⁻⁹), a rounding under 2⁻⁹
    a step of O(1) convex combinations."""
    if dtype == torch.bfloat16:
        return {"rtol": 0.0, "atol": max(1e-2, steps * 2.0 ** -9)}
    return {"rtol": 1e-5, "atol": 1e-6}


def timed_ms(fn: Callable[[int], torch.Tensor], iters: int, device: torch.device, repeats: int = 3) -> float:
    """Best of ``repeats`` runs of ``fn(0) .. fn(iters - 1)``, ms a call:
    CUDA events on the card (after one warm-up call), the host clock on
    the CPU."""
    fn(0)
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(i)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(i)
            best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def check_predict(size: int, iters: int = 4, device: Optional[torch.device] = None,
                  model_args: Optional[dict] = None) -> dict:
    """Full-width ``cod`` (seeded weights; ``model_args`` override HitNet's
    settings) predict at batch 1, bf16, at ``size``²."""
    from ..models.cod import cod

    device = resolve_device(device)
    t0 = time.perf_counter()
    model = cod(dtype=torch.bfloat16, seed=0, **(model_args or {})).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    images = torch.rand((iters, 1, size, size, 3), generator=g, device=device)
    depths = torch.rand((iters, 1, size, size, 1), generator=g, device=device)
    before = _launches()
    ms = timed_ms(lambda i: model.predict(images[i], depths[i])[0], iters, device)
    launches = _delta(before)  # of the warm-up call and 3 timed runs of iters calls
    prob = model.predict(images[0], depths[0])[0]
    ok = tuple(prob.shape) == (1, size, size, 1) and bool(torch.isfinite(prob).all())
    return {"check": f"predict_{size}sq_bs1", "ms_per_image": ms, "images_per_sec": 1e3 / ms,
            "setup_plus_bench_s": time.perf_counter() - t0, "stencil_launches": launches, "ok": ok,
            "device": _device_name(device)}


def diffusion_nhwc_plain(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """The plain version on NHWC with channel-major weights (the JAX
    ``message_passing_step``): x (B, H, W, C), w (B, H, W, C, k²); fp32
    inside, each step stored in x's dtype."""
    b, h, wd, c = x.shape
    wf = w.float().permute(0, 3, 4, 1, 2)  # (B, C, k², H, W)
    for _ in range(steps):
        taps = F.unfold(x.float().permute(0, 3, 1, 2), kernel, padding=kernel // 2)
        x = (taps.view(b, c, kernel * kernel, h, wd) * wf).sum(2).permute(0, 2, 3, 1).to(x.dtype)
    return x


def nhwc_wrapper(x: torch.Tensor, w: torch.Tensor, kernel: int, steps: int) -> torch.Tensor:
    """``diffusion_planes`` inside the JAX ``diffusion_pallas_v2``'s
    transposes: NHWC x and channel-major w to planes, and back."""
    b, h, wd, c = x.shape
    xp = x.permute(0, 3, 1, 2).reshape(b * c, h, wd).contiguous()
    wp = w.permute(0, 3, 4, 1, 2).reshape(b * c, kernel * kernel, h, wd).contiguous()
    return D.diffusion_planes(xp, wp, kernel, steps).reshape(b, c, h, wd).permute(0, 2, 3, 1)


def check_diffusion(grid: int = 512, c: int = 24, kernel: int = 7, steps: int = 4, iters: int = 4,
                    device: Optional[torch.device] = None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The three legs on (1, grid, grid, c) inputs; iteration i adds i/64
    to x (``iters`` copies), w is one resident copy a layout."""
    from ..models.diffusion import normalize_affinity

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, grid, grid, c), generator=g, device=device)
    xs = [(x + i / 64).to(dtype) for i in range(iters)]
    w = normalize_affinity(torch.rand((1, grid, grid, c, kernel * kernel), generator=g, device=device),
                           dim=-1).to(dtype)
    tol = stencil_tolerance(dtype, steps)
    res = {"check": f"diffusion_{grid}sq_c{c}_k{kernel}_s{steps}", "dtype": str(dtype).replace("torch.", ""),
           "tolerance": tol}

    try:
        ref = diffusion_nhwc_plain(xs[0], w, kernel, steps)
        res["plain_torch_ms"] = timed_ms(lambda i: diffusion_nhwc_plain(xs[i], w, kernel, steps), iters, device)
    except torch.cuda.OutOfMemoryError as e:
        ref = None
        res["plain_torch_ms"] = f"OOM: {str(e)[:120]}"
        torch.cuda.empty_cache()

    errs, launches = {}, {}

    def leg(name, fn, out_nhwc):
        before = _launches()
        res[f"{name}_ms"] = timed_ms(fn, iters, device)
        launches[name] = _delta(before)
        got = out_nhwc(fn(0)).float()
        if ref is not None:
            errs[name] = (got - ref.float()).abs().max().item()
            ok = torch.allclose(got, ref.float(), **tol)
        else:  # the plain leg ran out of memory: hold the kernel legs to each other
            ok = bool(torch.isfinite(got).all())
        return got, ok

    wrapper_out, ok_wrapper = leg("nhwc_wrapper", lambda i: nhwc_wrapper(xs[i], w, kernel, steps), lambda y: y)
    # plane layouts replace the NHWC copies (one resident k²-field at a time)
    x_planes = [xi[0].permute(2, 0, 1).contiguous() for xi in xs]
    w_planes = w[0].permute(2, 3, 0, 1).reshape(c, kernel * kernel, grid, grid).contiguous()
    del w, xs
    planes_out, ok_planes = leg("planes", lambda i: D.diffusion_planes(x_planes[i], w_planes, kernel, steps),
                                lambda y: y.permute(1, 2, 0)[None])
    if ref is None:
        errs["planes_vs_nhwc_wrapper"] = (planes_out - wrapper_out).abs().max().item()
        ok_planes = ok_planes and torch.allclose(planes_out, wrapper_out, **tol)
    res["max_abs_err"] = errs
    res["stencil_launches"] = launches
    for num, ratio in (("plain_torch_ms", "planes_vs_plain"), ("nhwc_wrapper_ms", "planes_vs_nhwc_wrapper")):
        if isinstance(res[num], float):
            res[ratio] = res[num] / res["planes_ms"]
    res["ok"] = bool(ok_wrapper and ok_planes)
    res["device"] = _device_name(device)
    return res


def run(sizes=(704, 1024), grid: int = 512, skip_predict: bool = False, skip_diffusion: bool = False,
        device: Optional[torch.device] = None) -> List[dict]:
    """Every check, each JSON line printed as it completes; returns them."""
    device = resolve_device(device)
    results = []
    checks = [] if skip_diffusion else [lambda: check_diffusion(grid, device=device)]
    checks += [] if skip_predict else [lambda s=s: check_predict(s, device=device) for s in sizes]
    for check in checks:
        results.append(check())
        print(json.dumps(results[-1]), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[704, 1024])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--skip-predict", action="store_true")
    ap.add_argument("--skip-diffusion", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    results = run(args.sizes, args.grid, args.skip_predict, args.skip_diffusion, args.device)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
