"""What the per-layer readers share: the traced images' FLOPs and the
stencil kernels' share of their bound."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark import yardstick


def median(run, key: str) -> Optional[float]:
    vals = run.readings.get(key)
    return statistics.median(vals) if vals else None


def mfu(run, mode: str, kind: str) -> Optional[float]:
    """% of the bf16 dense peak: the configuration's FLOPs an image
    (``kind``: "forward" or "train") times the traced images over the
    traced window."""
    if run.cell.mode != mode or run.trace is None or run.device.type != "cuda":
        return None
    size = str(run.cell.traffic["size"])
    per_image = run.cell.config.get("flops_per_image", {}).get(size, {}).get(kind)
    if not per_image:
        return None
    return 100.0 * per_image * run.readings["images"] / run.trace.window_s / yardstick.PEAK_BF16_FLOPS


def idle_share(run, mode: str) -> Optional[float]:
    """% of the traced window with no operation on the device."""
    if run.cell.mode != mode or run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def stencil_roofline(run, mode: str, directions) -> Optional[float]:
    """% of roofline of the diffusion-stencil kernels of ``directions``
    ("fwd", "bwd"): their summed bound (one all-steps launch a call, the
    call's planes B·latent of the configuration's grid, in its compute
    dtype) over their summed device time; None without such kernels."""
    prompt = run.cell.config["architecture"].get("prompt")
    if run.cell.mode != mode or run.trace is None or prompt is None:
        return None
    planes = int(run.cell.traffic["batch"]) * prompt["latent_dim"]
    g, k, steps = prompt["grid"], prompt["kernel"], prompt["steps"]
    elem = 2 if run.cell.config["program"]["dtype"] == "bfloat16" else 4
    bound_s = device_s = 0.0
    for d in directions:
        secs, count = run.trace.kernel_seconds(lambda n, d=d: yardstick.stencil_kernels(n, d))
        fn = yardstick.stencil_bound if d == "fwd" else yardstick.stencil_bwd_bound
        bound_s += count * fn(planes, g, g, k, steps, elem)[0] * 1e-3
        device_s += secs
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
