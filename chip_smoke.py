#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     kernel of the served and trained paths from ``dgtd_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  2. hold the diffusion-stencil forward kernels against their plain PyTorch
     version (k in {1, 3, 7}; 12x12 and 13x20, which take the fused kernel,
     all 4 steps in one launch; 64x64 and 23x23, above the fused limit,
     which take the cluster kernel, all 4 steps in one launch of a thread
     block cluster a plane; 96x96, beyond the cluster's reach, which takes
     the per-step kernel; P = 192 planes, 48 at 96x96; fp32 and bf16), each
     case's launches read from the kernel's own counter;
  3. serve full-width ``cod`` (PVTv2-b2 + ConvNeXt-B, seeded random weights)
     at 384², batch 8, through ``dgtd_tpu_torch.predict.main`` with a saved
     ``.pth``: once in bf16, once with ``--fp32``. The kernels' launch counts
     are reset just before each run and read just after (one fused forward a
     batch); masks are checked, bf16 is held to fp32, and the fp32 model on
     the card to the same model on the CPU on a small input;
  4. re-check the fused kernel against the plain version on the exact
     ``MessagePassing`` inputs captured during phase 3;
  5. time the fused kernel per call (CUDA events; through the autograd
     Function and the launch wrapper alone beside it), the per-step kernels
     on the same tensors, the plain version, and served batches;
  6. hold the stencil's backward kernels (fused, cluster, per-step) against
     the plain backward (the same cases at P = 240, 48 at 96x96, fp32 and
     bf16) and the autograd Function's 4-step backward (one fused launch
     each way) against autograd through the plain forward;
  7. tiny ``cod``: loss and every parameter gradient, fp32 on the card (TF32
     off) against the CPU, same weights and inputs, drop-path rates 0, at
     grid 8 (fused kernels) and at grid 64 (cluster kernels, one launch each
     way, read from their counters);
  8. train full-width ``cod`` through ``dgtd_tpu_torch.train.cli.main`` with
     ``configs/cod.yml`` (384², batch 10, bf16 autocast) on 30 synthetic
     images for 2 epochs (6 steps): finite losses, the launch counts (one
     fused forward and one fused backward a step), two epoch checkpoints,
     the second served through ``predict.main``; one fp32 first step held to
     the bf16 one; the backward kernel re-checked on the stencil inputs and
     upstream gradient captured in a train step;
  9. time train steps back to back (bf16 and fp32), the CLI loop, peak
     memory, and the fused backward kernel (CUDA events and device time)
     against its bound, the per-step kernels and its plain version;
 10. hold the three multi-scale deformable attention kernels (forward,
     dValue, dLocation/dWeight) against their plain versions: channels
     {30, 32, 64, 71, 1025, 2048, 3096} on two small levels and the 4-level
     layout, fp32 and bf16 value, locations off the levels and on integer
     pixel coordinates;
 11. train the ``MSDeformAttn`` layer at Deformable DETR's encoder width
     (d_model 256, 8 heads, 4 levels of 64²/32²/16²/8², 4 points; N = 2,
     Lq = S = 5440; seeded weights): 4 forward+backward iterations on
     distinct seeded reference points with each kernel's launch count read
     around them; the first iteration's output and every gradient held to
     the same layer on the CPU; a bf16-autocast iteration; the op, each
     kernel and its plain version timed at the captured tensors;
 12. the NHWC stencil on tap-major weights: its forward kernel against the
     plain version (the phase-2 grids, B = 8, C = 24, fp32 and bf16), its
     gradient (through the plane backward kernel) against autograd through
     the plain version, and its time at the served stencil's work;
 13. the LayerNorm kernel against its plain version (C in {64, 130, 1024,
     2048}, fp32 and bf16, mean-0 and mean-100 rows), then forward and
     backward at a PVTv2-b2 stage-1 and a ConvNeXt-B stage-1 shape of a
     served batch, timed beside ``F.layer_norm``;
 14. planes above the fused limit: the op forward and backward on
     (192, 64, 64) planes (the paper's grid-64 ablation), one cluster launch
     each way read from the counters, checked against the plain versions,
     timed in bf16 and fp32 beside the per-step kernels called directly on
     the same tensors; the cluster occupancy at 8 blocks and at a
     non-portable 16; then the per-step kernels' own path, (192, 96, 96)
     planes beyond the cluster's reach, one launch a step each way;
 15. ``cod`` at ``grid=64``: served through ``dgtd_tpu_torch.predict.main``
     with ``-o grid=64`` (bf16, batch 8; one cluster forward a batch) and
     trained through ``dgtd_tpu_torch.train.cli.main`` with
     ``-o model.grid=64`` (3 steps at batch 10, bf16; one cluster forward and
     one cluster backward a step), the launch counts read around each run;
     the cluster forward re-checked on the served stencil inputs; fp32 on the
     card held to the CPU on a small input; served ms per batch and train ms
     per step at grid 64 and grid 12 in turns;
 16. the device time per call of every stencil kernel timed in phases 5, 9
     and 14, from ``torch.profiler`` (last, so that its tracing cannot slow
     the host-bound timings).

Prints a ``kernels`` JSON line (the counterparts of the JAX package's seven
Pallas kernels, the plane stencil's forward and backward as the fused, the
cluster and the per-step kernels), a served-throughput line, a ``trained``,
a ``grid64`` and an ``msda`` JSON line, each with the card's name and power
limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL, STEPS, P_MAIN = 7, 4, 8 * 24  # served stencil: k=7, 4 steps, B·C planes
# 12x12 (the recipe's grid) and 13x20 take the fused kernels; 64x64 (the
# paper's grid-64 ablation, where the JAX package turns to Pallas) and 23x23
# (529 pixels, just above the fused limit) the cluster ones; 96x96 (beyond a
# cluster of 8 blocks of 512 pixels) the per-step ones
SHAPES = [(k, hw) for k in (1, 3, 7) for hw in ((12, 12), (13, 20), (64, 64), (23, 23), (96, 96))]
GRID64 = (64, 64)  # the cluster kernels' main path (phases 14, 15)
LARGE = (96, 96)  # the per-step kernels' own path (phase 14)
P_LARGE = 48  # planes of the 96x96 checks in phases 2 and 6, to keep their time
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
SOURCES = ["diffusion_stencil", "diffusion_stencil_bwd", "msda_fwd", "msda_bwd", "layernorm"]
# MSDA kernel checks: tests/test_msda.py's channel widths on its two small
# levels, and the 4-level layout of its backward test
MSDA_CHANNELS = (30, 32, 64, 71, 1025, 2048, 3096)
MSDA_SMALL = ((6, 4), (3, 2))
MSDA_FOUR = ((8, 8), (4, 4), (2, 2), (1, 1))
# tests/test_msda.py's tolerances (forward and dValue atol 1e-6, dLocation
# 1e-5, dWeight 1e-6, rtol 1e-4); a bf16 output one bf16 ulp (kernel and
# plain both sum in fp32 and round once)
MSDA_TOL = {"out": dict(rtol=1e-4, atol=1e-6), "dvalue": dict(rtol=1e-4, atol=1e-6),
            "dloc": dict(rtol=1e-4, atol=1e-5), "daw": dict(rtol=1e-4, atol=1e-6)}
MSDA_BF16_OUT_TOL = dict(rtol=2 ** -7, atol=1e-6)
# at the encoder layer's own tensors value is O(1) (value_proj of N(0, 1)
# inputs), not [0, 0.01): the channel sums that cancel (dLocation, dWeight)
# keep fp32 rounding of ~1e-7 of the sum of their |terms|, and dLocation
# carries a factor W_l = 64; there each output is held to 1e-6 of its
# largest entry where that exceeds the atol above
MSDA_SCALE_ATOL = 1e-6
# the encoder layer: tools/revalidate_onchip.py's MSDA configuration
ENC_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
ENC_N, ENC_D_MODEL, ENC_HEADS, ENC_POINTS, ENC_ITERS = 2, 256, 8, 4, 4
ENC_S = sum(h * w for h, w in ENC_SHAPES)  # = Lq = 5440
LAYER_RTOL = 1e-4  # card vs CPU, each tensor to 1e-4 of its largest entry
# the card's and the CPU's sampling locations (normalised): cuBLAS and MKL
# may round the offsets' linear differently, a few fp32 ulps of O(1)
# values (1.2e-7 each); 1e-6 is 6.4e-5 of a pixel at the 64-wide level, so
# the pin of the CPU run to the card's locations absorbs rounding only
LOC_PIN_ATOL = 1e-6
# LayerNorm: the same fp32 two-pass arithmetic in another order, at
# tests/test_layernorm_pallas.py's rtol 1e-4 / atol 1e-5; on mean-100 rows
# the means differ by a few ulps of 100 (7.6e-6 each) times rstd·|scale|, so
# atol 1e-4; bf16 one ulp
LN_FP32_TOL = {0.0: dict(rtol=1e-4, atol=1e-5), 100.0: dict(rtol=1e-4, atol=1e-4)}
LN_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LN_SHAPES = {"pvt_b2_stage1": (8 * 96 * 96, 64), "convnext_b_stage1": (8 * 96 * 96, 128)}


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


def device_ms(fn, iters, match):
    """Device time per call (ms) of the kernels whose name holds ``match``,
    summed from ``torch.profiler``'s ``key_averages()`` over ``iters`` calls;
    None if the profiler recorded no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if match in e.key)
    return us / 1e3 / iters if us > 0 else None


#: the order of plane_launches' counters
LAUNCH_NAMES = "fused fwd, fused bwd, cluster fwd, cluster bwd, step fwd, step bwd"


def plane_launches(D):
    """The plane stencil's launch counters: fused forward, fused backward,
    cluster forward, cluster backward, per-step forward, per-step backward."""
    return (D.FUSED_LAUNCHES, D.FUSED_BWD_LAUNCHES, D.CLUSTER_LAUNCHES, D.CLUSTER_BWD_LAUNCHES,
            D.LAUNCHES, D.BWD_LAUNCHES)


def reset_plane_launches(D):
    D.FUSED_LAUNCHES = D.FUSED_BWD_LAUNCHES = D.CLUSTER_LAUNCHES = D.CLUSTER_BWD_LAUNCHES = 0
    D.LAUNCHES = D.BWD_LAUNCHES = 0


def launch_tuple(route, n_fwd=0, n_bwd=0):
    """plane_launches' increments for n_fwd forward and n_bwd backward
    launches of one route's kernels."""
    add = [0] * 6
    slot = {"fused": 0, "cluster": 2, "per_step": 4}[route]
    add[slot], add[slot + 1] = n_fwd, n_bwd
    return tuple(add)


def expected_launches(D, shape, kernel, dtype, steps, bwd):
    """The counters' increments for one call of ``steps`` steps on planes
    of this (H, W): one fused or cluster launch, or one per-step launch a
    step."""
    route = D.stencil_route(*shape, kernel, dtype)
    n = steps if route == "per_step" else 1
    return launch_tuple(route, 0, n) if bwd else launch_tuple(route, n, 0)


def planes_for(hw, p):
    """P planes, or P_LARGE for the per-step kernels' large planes."""
    return P_LARGE if hw == LARGE else p


def stencil_bound(x, w, kernel, steps):
    """Least time (ms) for ``steps`` stencil steps on these inputs: x and w
    read once, the output written once, over HBM; 2 flops per weight per step
    over the fp32 rate (the kernel accumulates in fp32 on the CUDA cores)."""
    nbytes = (2 * x.numel() + w.numel()) * x.element_size()
    flops = 2.0 * w.numel() * steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(D, x, w, kernel, steps, label):
    """Kernel vs plain on the same inputs, and the kernel the shape names
    launched as often as it should; returns the max abs error."""
    import torch

    before = plane_launches(D)
    out = D.diffusion_planes(x, w, kernel, steps)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(plane_launches(D), before))
    want = expected_launches(D, x.shape[1:], kernel, x.dtype, steps, bwd=False)
    check(added == want, f"{label}: launches ({LAUNCH_NAMES}) {added}, expected {want}")
    label = f"{label} [{D.stencil_route(*x.shape[1:], kernel, x.dtype)}]"
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

    before = plane_launches(D)
    dx, dw = D.diffusion_planes_bwd(g, xs, w, kernel)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(plane_launches(D), before))
    want = expected_launches(D, g.shape[1:], kernel, g.dtype, len(xs), bwd=True)
    check(added == want, f"{label}: launches ({LAUNCH_NAMES}) {added}, expected {want}")
    label = f"{label} [{D.stencil_route(*g.shape[1:], kernel, g.dtype)}]"
    rdx, rdw = D.diffusion_planes_bwd_plain(g, xs, w, kernel)
    check(dx.dtype == g.dtype and dw.dtype == w.dtype, f"{label}: dtypes {dx.dtype} {dw.dtype}")
    tol = BWD_FP32_TOL if g.dtype == torch.float32 else BWD_BF16_TOL
    err = 0.0
    for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
        torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((got.float() - ref.float()).abs().max()))
    say(f"  {label}: max_abs_err={err:.3e}")
    return err


def msda_inputs(channels, seed, shapes, lq, n=2, m=2, p=3, dev="cuda"):
    """value in [0, 0.01) as tests/test_msda.py makes it (dLocation is a
    difference of corner sums over the channels, whose fp32 rounding at 3096
    channels of O(1) values alone would pass atol 1e-5), g in [0, 1); loc in
    [-0.2, 1.2) with a third of the samples on integer pixel coordinates
    (corners off every side); aw normalized over levels x points. fp32
    tensors on ``dev``."""
    import torch

    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.rand(n, s, m, channels).astype(np.float32) * 0.01
    loc = (rng.rand(n, lq, m, len(shapes), p, 2) * 1.4 - 0.2).astype(np.float32)
    third = lq // 3
    for lid, (h, w) in enumerate(shapes):
        loc[:, :third, :, lid, :, 0] = (rng.randint(-1, w + 1, size=(n, third, m, p)) + 0.5) / w
        loc[:, :third, :, lid, :, 1] = (rng.randint(-1, h + 1, size=(n, third, m, p)) + 0.5) / h
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32) + 1e-5
    aw /= aw.sum(axis=(-1, -2), keepdims=True)
    g = rng.rand(n, lq, m * channels).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (value, loc, aw, g)]


def check_msda(A, value, loc, aw, g, shapes, label, scale_atol=0.0):
    """The three MSDA kernels vs their plain versions on the same inputs;
    returns the max abs error of each output. ``scale_atol`` raises each
    atol to that fraction of the output's largest entry."""
    import torch

    out = A.ms_deform_attn_fwd(value, shapes, loc, aw)
    dv = A.ms_deform_attn_dvalue(g, value, shapes, loc, aw)
    dloc, daw = A.ms_deform_attn_dlocw(g, value, shapes, loc, aw)
    torch.cuda.synchronize()
    check(out.dtype == value.dtype and dv.dtype == dloc.dtype == daw.dtype == torch.float32,
          f"{label}: dtypes {out.dtype} {dv.dtype} {dloc.dtype} {daw.dtype}")
    rdl, rda = A.ms_deform_attn_dlocw_plain(g, value, shapes, loc, aw)
    refs = {"out": A.ms_deform_attn_plain(value, shapes, loc, aw),
            "dvalue": A.ms_deform_attn_dvalue_plain(g, value, shapes, loc, aw), "dloc": rdl, "daw": rda}
    errs = {}
    for name, got in (("out", out), ("dvalue", dv), ("dloc", dloc), ("daw", daw)):
        tol = dict(MSDA_BF16_OUT_TOL if name == "out" and value.dtype != torch.float32 else MSDA_TOL[name])
        got, ref = got.float(), refs[name].float()
        tol["atol"] = max(tol["atol"], scale_atol * float(ref.abs().max()))
        torch.testing.assert_close(got, ref, **tol, msg=lambda msg: f"{label} {name}: {msg}")
        errs[name] = float((got - ref).abs().max())
    return errs


def msda_corners(loc, shapes):
    """In-range bilinear corners of these locations (the kernels skip the
    others), and the samples with at least one: the data-dependent part of
    the MSDA work."""
    import torch

    corners, live = 0, 0
    for lid, (h, w) in enumerate(shapes):
        x = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5)
        any_in = torch.zeros_like(x, dtype=torch.bool)
        for dy in (0, 1):
            for dx in (0, 1):
                inside = ((x + dx) >= 0) & ((x + dx) < w) & ((y + dy) >= 0) & ((y + dy) < h)
                corners += int(inside.sum())
                any_in |= inside
        live += int(any_in.sum())
    return corners, live


def msda_bounds(value, loc, aw, shapes):
    """Least time (ms) of each MSDA kernel on these inputs, and what bounds
    it. Bytes: each input read once, each output written once (forward: value,
    loc, aw -> out; dValue: g, loc, aw -> an fp32 value-sized gradient;
    dLocation/dWeight: g, value, loc, aw -> dloc, daw in fp32). Operations on
    the fp32 rate: per in-range corner and channel, 2 (forward FMA), 2
    (dValue's product and add); per channel of a sample with an in-range
    corner, 18 for dLocation/dWeight: s, ds/dx and ds/dy from shared lerps
    (t0 = v00 + fx(v01 - v00), t1 = v10 + fx(v11 - v10), ds/dy = t1 - t0,
    s = t0 + fy ds/dy, ds/dx = d0 + fy(d1 - d0): 12) and their three
    products with g summed (6)."""
    n, s, m, d = value.shape
    es = value.element_size()
    g_bytes = loc.shape[1] * n * m * d * es
    lb, ab = loc.numel() * 4, aw.numel() * 4
    corners, live = msda_corners(loc, shapes)
    work = {
        "msda_fwd": (value.numel() * es + lb + ab + g_bytes, 2.0 * corners * d),
        "msda_dvalue": (g_bytes + lb + ab + value.numel() * 4, 2.0 * corners * d),
        "msda_dlocw": (g_bytes + value.numel() * es + 2 * (lb + ab), 18.0 * live * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def layer_norm_bound(x):
    """Least time (ms) of one LayerNorm on x: x read and the output written
    once, scale and bias (fp32) read once; ~8 flops per value on the fp32
    rate."""
    c = x.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 8.0 * x.numel() / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_rel_to_scale(got, ref):
    """max |got - ref| over the largest |ref|."""
    return float((got.float().cpu() - ref.float()).abs().max()) / max(float(ref.abs().max()), 1e-30)


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
    import copy

    import torch
    import torch.nn.functional as F

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
    _build.build(SOURCES)
    say(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "ptxas" in line:
                say(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 2: forward kernels (fused, cluster, per-step) vs plain (P={P_MAIN}, {P_LARGE} at {LARGE}, 4 steps)")
    g = torch.Generator(device=dev).manual_seed(0)
    for k, (h, w) in SHAPES:
        p = planes_for((h, w), P_MAIN)
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
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
                reset_plane_launches(D)
                summaries[name] = P.main(argv)
                launches[name] = plane_launches(D)
                torch.cuda.synchronize()
                nb = summaries[name]["batches"]
                say(f"  {name}: {summaries[name]['images']} images in {nb} batches, "
                    f"loop {summaries[name]['loop_s']:.3f} s, stencil launches ({LAUNCH_NAMES}) {launches[name]}")
                check(launches[name] == launch_tuple("fused", nb), (name, launches[name], nb))
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
    say("phase 4: fused kernel vs plain on captured MessagePassing inputs")
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
    say("phase 5: timings (CUDA events around calls back to back)")
    # (label, row, key, call, kernel name, calls): the profiler reads each
    # call's device time at the end (phase 14)
    rows, device_calls = {}, []
    for name in ("bf16", "fp32"):
        xp, wt, err = served[name]
        # (the tensors bound now: the calls run again at the end)
        fused = functools.partial(D.diffusion_planes, xp, wt, KERNEL, STEPS)
        # the per-step kernels on the same tensors, as the op ran them before
        # the fused kernel, for a comparison within one call
        per_step = lambda xp=xp, wt=wt: D._per_step_forward(xp, wt, KERNEL, STEPS, None, torch.empty_like(xp))
        ms, step_ms = cuda_time_ms(fused, 200), cuda_time_ms(per_step, 200)
        # the host layers of a call: through the autograd Function (as a call
        # that records a gradient pays it), and the launch wrapper alone
        function_ms = cuda_time_ms(lambda: D.DiffusionPlanesFn.apply(xp, wt, KERNEL, STEPS), 200)
        launch_ms = cuda_time_ms(lambda: D._fused_forward(xp, wt, KERNEL, STEPS, None, torch.empty_like(xp)), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_plain(xp, wt, KERNEL, STEPS), 200)
        bound_ms, bound_by = stencil_bound(xp, wt, KERNEL, STEPS)
        rows[name] = dict(ms=ms, function_ms=function_ms, launch_ms=launch_ms, per_step_ms=step_ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)
        say(f"  stencil {name} ({STEPS} steps, {P_MAIN}x12x12, k={KERNEL}): fused {ms:.5f} ms per call (through the "
            f"Function {function_ms:.5f}, launch wrapper alone {launch_ms:.5f}); per-step kernels {step_ms:.5f} ms "
            f"per call; plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
        device_calls += [(f"fused forward {name}", rows[name], "device_ms", fused, "stencil_fused_fwd", 200),
                         (f"per-step forward {name}", rows[name], "per_step_device_ms", per_step, "stencil_step_kernel", 200)]

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
    say(f"phase 6: backward kernels (fused, cluster, per-step) vs plain backward (P={P_TRAIN}, {P_LARGE} at {LARGE})")
    for k, (h, w) in SHAPES:
        p = planes_for((h, w), P_TRAIN)
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
        gr = torch.rand(p, h, w, generator=g, device=dev)
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
        before = plane_launches(D)
        D.diffusion_planes(xa, wa, KERNEL, STEPS).backward(gout)
        torch.cuda.synchronize()
        check(plane_launches(D) == tuple(b + a for b, a in zip(before, launch_tuple("fused", 1, 1))),
              f"Function {name}: launches {before} -> {plane_launches(D)}")
        D.diffusion_planes_plain(xb, wb, KERNEL, STEPS).backward(gout)
        err = 0.0
        for gname, got, ref in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"Function {name} {gname}: {m}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        say(f"  Function {name}, {STEPS} steps, vs autograd through the plain forward: max_abs_err={err:.3e}")

    # ---- 7. tiny cod: loss and gradients, card vs CPU ----
    say("phase 7: tiny cod loss and every parameter gradient, fp32 card (TF32 off) vs CPU, grids 8 and 64")
    for grid in (TINY["grid"], GRID64[0]):
        m_cpu = cod(dtype=torch.float32, seed=0, **{**TINY, "grid": grid})
        m_dev = copy.deepcopy(m_cpu).to(dev)
        rng = np.random.RandomState(5)
        inputs = [torch.from_numpy(a) for a in (
            rng.randn(2, 64, 64, 3).astype(np.float32), rng.rand(2, 64, 64, 1).astype(np.float32),
            (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32))]
        loss_cpu = m_cpu.loss(*inputs)[0]
        loss_cpu.backward()
        reset_plane_launches(D)
        loss_dev = m_dev.loss(*[t.to(dev) for t in inputs])[0]
        loss_dev.backward()
        torch.cuda.synchronize()
        route = D.stencil_route(grid, grid, KERNEL, torch.float32)
        check(plane_launches(D) == launch_tuple(route, 1, 1), f"tiny cod grid {grid}: launches {plane_launches(D)}")
        loss_cpu, loss_dev = loss_cpu.item(), loss_dev.item()
        check(abs(loss_dev - loss_cpu) <= TINY_LOSS_RTOL * abs(loss_cpu), f"tiny loss card {loss_dev} vs CPU {loss_cpu}")
        grads_cpu = dict(m_cpu.named_parameters())
        scale = max(float(p.grad.abs().max()) for p in grads_cpu.values())
        worst = (0.0, "")
        for n, p in m_dev.named_parameters():
            ref = grads_cpu[n].grad
            diff = float((p.grad.cpu() - ref).abs().max())
            limit = TINY_GRAD_RTOL * max(float(ref.abs().max()), 1e-4 * scale)
            check(diff <= limit, f"grid {grid} gradient of {n}: card vs CPU {diff:.3e} > {limit:.3e}")
            worst = max(worst, (diff / limit, n))
        say(f"  grid {grid} ({route} stencil kernels, launches ({LAUNCH_NAMES}) {plane_launches(D)}): loss card "
            f"{loss_dev:.7f} CPU {loss_cpu:.7f}; {len(grads_cpu)} gradients within {TINY_GRAD_RTOL} of their "
            f"scale (closest to its limit: {worst[1]} at {worst[0]:.3f} of it)")
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
            reset_plane_launches(D)
            trained = TC.main(argv)
            train_launches = plane_launches(D)
            cli_peak = torch.cuda.max_memory_allocated()
        finally:
            MD.diffusion_planes = planes_unspied
        fwd_launches, bwd_launches = train_launches[:2]
        say(f"  {trained['steps']} steps in {trained['loop_s']:.3f} s; stencil launches ({LAUNCH_NAMES}) "
            f"{train_launches}; peak memory {cli_peak / 2**30:.3f} GiB")
        check(trained["steps"] == TRAIN_STEPS, trained)
        check(train_launches == launch_tuple("fused", TRAIN_STEPS, TRAIN_STEPS),
              f"launches {train_launches}: one fused forward and one fused backward a step in {TRAIN_STEPS} steps")
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
        reset_plane_launches(D)
        P.main(["--checkpoint", ckpts[-1], "--image-dir", os.path.join(serve, "img"),
                "--depth-dir", os.path.join(serve, "dep"), "--out-dir", out_dir,
                "--size", str(SIZE), "--batch", str(TRAIN_BATCH)])
        check(plane_launches(D) == launch_tuple("fused", 1), f"serving the trained checkpoint: launches {plane_launches(D)}")
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
        # the step inputs as the Function saves them: one (steps, P, H, W) tensor
        tg, txs, tw = gg.to(dt), torch.stack(gxs).to(dt), gw.to(dt)
        fused = functools.partial(D.diffusion_planes_bwd, tg, txs, tw, KERNEL)
        per_step = functools.partial(D._per_step_backward, tg, txs, tw, KERNEL)  # the design before, same tensors
        ms, step_ms = cuda_time_ms(fused, 200), cuda_time_ms(per_step, 200)
        launch_ms = cuda_time_ms(lambda: D._fused_backward(tg, txs, tw, KERNEL), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_bwd_plain(tg, txs, tw, KERNEL), 50)
        bound_ms, bound_by = stencil_bwd_bound(tg, txs, tw, KERNEL)
        bwd_rows[name] = dict(ms=ms, launch_ms=launch_ms, per_step_ms=step_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        say(f"  stencil backward {name} ({STEPS} steps, {P_TRAIN}x12x12, k={KERNEL}): fused {ms:.5f} ms per call "
            f"(launch wrapper alone {launch_ms:.5f}); per-step kernels {step_ms:.5f} ms per call; plain "
            f"{plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
        device_calls += [(f"fused backward {name}", bwd_rows[name], "device_ms", fused, "stencil_fused_bwd", 200),
                         (f"per-step backward {name}", bwd_rows[name], "per_step_device_ms", per_step, "stencil_bwd_kernel", 200)]
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

    del runner, batch
    torch.cuda.empty_cache()

    # ---- 10. MSDA kernels vs plain ----
    from dgtd_tpu_torch.ops import layernorm as L
    from dgtd_tpu_torch.ops import msda as A

    say("phase 10: MSDA kernels vs plain (forward, dValue, dLocation/dWeight)")
    cases = [(c, MSDA_SMALL, dict(lq=40)) for c in MSDA_CHANNELS]
    cases.append((32, MSDA_FOUR, dict(lq=150, m=8, p=4)))
    for i, (channels, shapes, kw) in enumerate(cases):
        value, loc, aw, gr = msda_inputs(channels, 100 + i, shapes, dev=dev, **kw)
        for name, v, gv in (("fp32", value, gr), ("bf16", value.bfloat16(), gr.bfloat16())):
            errs = check_msda(A, v, loc, aw, gv, shapes, f"{name} D={channels} {len(shapes)} levels")
            say(f"  {name} D={channels}, {len(shapes)} levels: max_abs_err " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))

    # ---- 11. the MSDeformAttn layer at Deformable DETR's encoder width ----
    say(f"phase 11: MSDeformAttn d_model {ENC_D_MODEL}, {ENC_HEADS} heads, levels {ENC_SHAPES}, {ENC_POINTS} points; "
        f"N={ENC_N}, Lq=S={ENC_S}; {ENC_ITERS} forward+backward iterations, fp32 (TF32 off)")
    layer = A.MSDeformAttn(ENC_D_MODEL, len(ENC_SHAPES), ENC_HEADS, ENC_POINTS, seed=0)
    layer_cpu = copy.deepcopy(layer)
    layer.to(dev)
    rng = np.random.RandomState(11)
    query_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    value_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    target_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    refs_np = [rng.rand(ENC_N, ENC_S, len(ENC_SHAPES), 2).astype(np.float32) for _ in range(ENC_ITERS)]
    query, value_in, target = (torch.from_numpy(a).to(dev) for a in (query_np, value_np, target_np))
    op_unspied, grabbed = A.ms_deform_attn, {}

    def spy_op(v, shapes, loc, aw):
        grabbed.setdefault("op", (v.detach().clone(), loc.detach().clone(), aw.detach().clone()))
        return op_unspied(v, shapes, loc, aw)

    def layer_iteration(lay, q, r, v, tgt):
        lay.zero_grad(set_to_none=True)
        q, v = q.clone().requires_grad_(), v.clone().requires_grad_()
        out = lay(q, r, v, ENC_SHAPES)
        loss = ((out.float() - tgt) ** 2).mean()
        loss.backward()
        return out.detach(), loss.detach(), q.grad, v.grad

    A.ms_deform_attn = spy_op
    try:
        first = None
        A.LAUNCHES = A.DVALUE_LAUNCHES = A.DLOCW_LAUNCHES = 0
        for it in range(ENC_ITERS):
            res = layer_iteration(layer, query, torch.from_numpy(refs_np[it]).to(dev), value_in, target)
            if first is None:
                first = (res, {n: p.grad.detach().clone() for n, p in layer.named_parameters()})
        torch.cuda.synchronize()
        msda_launches = {"msda_fwd": A.LAUNCHES, "msda_dvalue": A.DVALUE_LAUNCHES, "msda_dlocw": A.DLOCW_LAUNCHES}
    finally:
        A.ms_deform_attn = op_unspied
    say(f"  launches in {ENC_ITERS} iterations: {msda_launches}")
    for name, n_launch in msda_launches.items():
        check(n_launch == ENC_ITERS, f"{name}: {n_launch} launches in {ENC_ITERS} iterations (one per call)")
    (out_dev, loss_dev, dq_dev, dv_dev), pgrads_dev = first
    check(bool(torch.isfinite(out_dev).all()) and out_dev.shape == (ENC_N, ENC_S, ENC_D_MODEL), out_dev.shape)

    # the CPU run samples at the card's locations: cuBLAS and MKL round the
    # offsets' linear differently, which moves a few of the 1.39M samples
    # across a pixel coordinate, where dLocation jumps; the gradient still
    # flows through the CPU's own locations
    card_loc, pin = grabbed["op"][1].cpu(), {}

    def pinned_op(v, shapes, loc, aw):
        pin["max_loc_diff"] = float((card_loc - loc.detach()).abs().max())
        return op_unspied(v, shapes, loc + (card_loc - loc).detach(), aw)

    t0 = time.perf_counter()
    A.ms_deform_attn = pinned_op
    try:
        out_cpu, loss_cpu, dq_cpu, dv_cpu = layer_iteration(
            layer_cpu, torch.from_numpy(query_np), torch.from_numpy(refs_np[0]), torch.from_numpy(value_np),
            torch.from_numpy(target_np))
    finally:
        A.ms_deform_attn = op_unspied
    cpu_s = time.perf_counter() - t0
    layer_errs = {"out": max_rel_to_scale(out_dev, out_cpu), "d_query": max_rel_to_scale(dq_dev, dq_cpu),
                  "d_value": max_rel_to_scale(dv_dev, dv_cpu)}
    for n, p in layer_cpu.named_parameters():
        layer_errs[f"d_{n}"] = max_rel_to_scale(pgrads_dev[n], p.grad)
    worst = max(layer_errs.items(), key=lambda kv: kv[1])
    say(f"  card vs CPU (plain path, {cpu_s:.1f} s; locations pinned to the card's, which differed by at most "
        f"{pin['max_loc_diff']:.2e}), first iteration: loss {float(loss_dev):.7f} vs {float(loss_cpu):.7f}; "
        f"{len(layer_errs)} tensors within {LAYER_RTOL} of their scale (worst {worst[0]} at {worst[1]:.2e})")
    check(pin["max_loc_diff"] <= LOC_PIN_ATOL,
          f"MSDeformAttn locations: card vs CPU {pin['max_loc_diff']:.2e} > {LOC_PIN_ATOL} (more than rounding)")
    for name, err in layer_errs.items():
        check(err <= LAYER_RTOL, f"MSDeformAttn {name}: card vs CPU {err:.2e} of its scale > {LAYER_RTOL}")
    del layer_cpu, out_cpu, dq_cpu, dv_cpu

    with torch.autocast("cuda", dtype=torch.bfloat16):
        out16, _, dq16, dv16 = layer_iteration(layer, query, torch.from_numpy(refs_np[0]).to(dev), value_in, target)
    torch.cuda.synchronize()
    check(out16.dtype == torch.bfloat16 and bool(torch.isfinite(out16.float()).all()), f"bf16 layer output {out16.dtype}")
    check(bool(torch.isfinite(dq16).all() and torch.isfinite(dv16).all()), "bf16 layer gradients finite")
    say(f"  bf16 autocast iteration: output {out16.dtype} finite, |out - fp32 out| max "
        f"{float((out16.float() - out_dev).abs().max()):.3e} (scale {float(out_dev.abs().max()):.3e})")

    ev, el, ea = grabbed["op"]
    check(ev.shape == (ENC_N, ENC_S, ENC_HEADS, ENC_D_MODEL // ENC_HEADS) and ev.dtype == torch.float32, ev.shape)
    eg = torch.from_numpy(np.random.RandomState(12).rand(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)).to(dev)
    enc_errs = check_msda(A, ev, el, ea, eg, ENC_SHAPES, "encoder shape fp32", scale_atol=MSDA_SCALE_ATOL)
    say("  kernels vs plain on the layer's captured tensors: " + ", ".join(f"{k} {e:.3e}" for k, e in enc_errs.items()))
    msda_bound = msda_bounds(ev, el, ea, ENC_SHAPES)
    msda_rows = {}
    timed = {
        "msda_fwd": (lambda: A.ms_deform_attn_fwd(ev, ENC_SHAPES, el, ea),
                     lambda: A.ms_deform_attn_plain(ev, ENC_SHAPES, el, ea), ("out",)),
        "msda_dvalue": (lambda: A.ms_deform_attn_dvalue(eg, ev, ENC_SHAPES, el, ea),
                        lambda: A.ms_deform_attn_dvalue_plain(eg, ev, ENC_SHAPES, el, ea), ("dvalue",)),
        "msda_dlocw": (lambda: A.ms_deform_attn_dlocw(eg, ev, ENC_SHAPES, el, ea),
                       lambda: A.ms_deform_attn_dlocw_plain(eg, ev, ENC_SHAPES, el, ea), ("dloc", "daw")),
    }
    for name, (kern, plain, outs) in timed.items():
        ms = cuda_time_ms(kern, 100)
        plain_ms = cuda_time_ms(plain, 10, warmup=2)
        bound_ms, bound_by = msda_bound[name]
        msda_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               err=max(enc_errs[o] for o in outs))
        say(f"  {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    vr, lr, ar = (t.clone().requires_grad_() for t in (ev, el, ea))
    op_fwd_ms = cuda_time_ms(lambda: A.ms_deform_attn(ev, ENC_SHAPES, el, ea), 100)
    op_step_ms = cuda_time_ms(lambda: torch.autograd.grad(A.ms_deform_attn(vr, ENC_SHAPES, lr, ar), (vr, lr, ar), eg), 50)
    op_out = A.ms_deform_attn(vr, ENC_SHAPES, lr, ar)
    op_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(op_out, (vr, lr, ar), eg, retain_graph=True), 50)
    refs1 = torch.from_numpy(refs_np[1]).to(dev)
    layer_step_ms = cuda_time_ms(lambda: layer_iteration(layer, query, refs1, value_in, target), 20, warmup=3)
    say(f"  op forward {op_fwd_ms:.5f} ms, op backward {op_bwd_ms:.5f} ms, op forward+backward {op_step_ms:.5f} ms, layer iteration "
        f"(4 linears, softmax, op, MSE, backward) {layer_step_ms:.5f} ms [{card}]")
    del layer, ev, el, ea, eg, vr, lr, ar, op_out, query, value_in, target, refs1
    torch.cuda.empty_cache()

    # ---- 12. NHWC stencil on tap-major weights ----
    say("phase 12: NHWC stencil (tap-major weights) vs plain; gradient through the plane backward kernel")
    for k, (h, w) in SHAPES:
        x = torch.rand(8, h, w, 24, generator=g, device=dev)
        nw = MD.normalize_affinity(torch.rand(8, h, w, 24, k * k, generator=g, device=dev), dim=-1)
        wt = D.to_tap_major(nw)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            out = D.diffusion_nhwc_tap_major(x.to(dt), wt.to(dt), k, STEPS)
            torch.cuda.synchronize()
            ref = D.diffusion_nhwc_plain(x.to(dt).float(), wt.to(dt).float(), k, STEPS)
            tol = FP32_TOL if dt == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
            torch.testing.assert_close(out.float(), ref, **tol, msg=lambda m: f"NHWC {name} k={k} {h}x{w}: {m}")
            say(f"  {name} k={k} {h}x{w}: max_abs_err={float((out.float() - ref).abs().max()):.3e}")
    x = torch.rand(8, 12, 12, 24, generator=g, device=dev)
    nw = MD.normalize_affinity(torch.rand(8, 12, 12, 24, KERNEL ** 2, generator=g, device=dev), dim=-1)
    gout = torch.rand(8, 12, 12, 24, generator=g, device=dev)
    nhwc_grad_err = {}
    for name, dt, tol in (("fp32", torch.float32, BWD_FP32_TOL), ("bf16", torch.bfloat16, AUTOGRAD_BF16_TOL)):
        xa, wa, xb, wb = (t.to(dt).clone().requires_grad_() for t in (x, nw, x, nw))
        D.NHWC_LAUNCHES = 0
        reset_plane_launches(D)
        D.diffusion_nhwc(xa, wa, KERNEL, STEPS).backward(gout.to(dt))
        torch.cuda.synchronize()
        # the backward's 12x12 planes take the fused plane backward: one launch
        nhwc_launches = (D.NHWC_LAUNCHES, D.FUSED_BWD_LAUNCHES)
        check(nhwc_launches == (STEPS, 1) and plane_launches(D) == launch_tuple("fused", 0, 1),
              f"NHWC {name} forward+backward launches {nhwc_launches}, plane {plane_launches(D)}")
        D.diffusion_nhwc_plain(xb, D.to_tap_major(wb), KERNEL, STEPS).backward(gout.to(dt))
        err = 0.0
        for gname, got, ref in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"NHWC {name} {gname}: {m}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        nhwc_grad_err[name] = err
        say(f"  NHWC {name} x (8,12,12,24), k={KERNEL}, {STEPS} steps: launches forward {nhwc_launches[0]}, "
            f"backward {nhwc_launches[1]}; gradients vs autograd through the plain forward max_abs_err={err:.3e}")
    nhwc_rows = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        xt, wt = x.to(dt), D.to_tap_major(nw).to(dt)
        out = D.diffusion_nhwc_tap_major(xt, wt, KERNEL, STEPS)
        ref = D.diffusion_nhwc_plain(xt, wt, KERNEL, STEPS)
        err = float((out.float() - ref.float()).abs().max())
        ms = cuda_time_ms(lambda: D.diffusion_nhwc_tap_major(xt, wt, KERNEL, STEPS), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_nhwc_plain(xt, wt, KERNEL, STEPS), 50)
        bound_ms, bound_by = stencil_bound(xt, wt, KERNEL, STEPS)
        nhwc_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)
        say(f"  NHWC stencil {name} ({STEPS} steps, x (8,12,12,24), w (8,12,12,{KERNEL ** 2}*24)): kernel {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")

    # ---- 13. LayerNorm ----
    say("phase 13: LayerNorm kernel vs plain; forward+backward at served stage-1 shapes")
    for c in (64, 130, 1024, 2048):
        for mean in (0.0, 100.0):
            xl = torch.randn(1000, c, generator=g, device=dev) * 3 + mean
            sc, bi = torch.randn(c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)
            for name, dt, tol in (("fp32", torch.float32, LN_FP32_TOL[mean]), ("bf16", torch.bfloat16, LN_BF16_TOL)):
                out = L.layer_norm_fwd(xl.to(dt), sc, bi, 1e-6)
                torch.cuda.synchronize()
                ref = L.layer_norm_plain(xl.to(dt), sc, bi, 1e-6)
                check(out.dtype == dt, f"LayerNorm output dtype {out.dtype}")
                torch.testing.assert_close(out.float(), ref.float(), **tol, msg=lambda m: f"LayerNorm {name} C={c} mean {mean}: {m}")
            say(f"  C={c}, mean {mean:g}: fp32 and bf16 within tolerance")
    ln_rows, ln_launches = {}, 0
    for shape_name, (rows_n, c) in LN_SHAPES.items():
        xl = (torch.randn(rows_n, c, generator=g, device=dev) * 3 + 1).bfloat16()
        # fp32 scale and bias whose values bf16 holds exactly, so that
        # F.layer_norm below takes the same values (see there)
        sc = torch.randn(c, generator=g, device=dev).bfloat16().float()
        bi = torch.randn(c, generator=g, device=dev).bfloat16().float()
        xr, sr, br = xl.clone().requires_grad_(), sc.clone().requires_grad_(), bi.clone().requires_grad_()
        L.LAUNCHES = 0
        L.layer_norm(xr, sr, br, 1e-6).float().pow(2).mean().backward()
        torch.cuda.synchronize()
        check(L.LAUNCHES == 1 and xr.grad is not None and bool(torch.isfinite(xr.grad.float()).all()),
              f"LayerNorm {shape_name}: {L.LAUNCHES} launches")
        ln_launches += L.LAUNCHES
        out = L.layer_norm_fwd(xl, sc, bi, 1e-6)
        err = float((out.float() - L.layer_norm_plain(xl, sc, bi, 1e-6).float()).abs().max())
        ms = cuda_time_ms(lambda: L.layer_norm_fwd(xl, sc, bi, 1e-6), 200)
        plain_ms = cuda_time_ms(lambda: L.layer_norm_plain(xl, sc, bi, 1e-6), 100)
        # one PyTorch call computes the same function: F.layer_norm refuses a
        # bf16 x with fp32 scale and bias on CUDA ("expected scalar type
        # BFloat16"), so it gets them in bf16, which holds their values
        # exactly; it computes its statistics and the affine in fp32 as the
        # kernel does, so the outputs agree to one bf16 ulp
        sl, bl = sc.to(xl.dtype), bi.to(xl.dtype)
        check(torch.equal(sl.float(), sc) and torch.equal(bl.float(), bi), "LayerNorm: scale or bias not bf16-exact")
        torch.testing.assert_close(F.layer_norm(xl, (c,), sl, bl, 1e-6).float(), out.float(), **LN_BF16_TOL,
                                   msg=lambda m: f"F.layer_norm vs the kernel, {shape_name}: {m}")
        library_ms = cuda_time_ms(lambda: F.layer_norm(xl, (c,), sl, bl, 1e-6), 200)
        bound_ms, bound_by = layer_norm_bound(xl)
        ln_rows[shape_name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, err=err, shape=[rows_n, c], dtype="bfloat16")
        say(f"  LayerNorm {shape_name} ({rows_n}, {c}) bf16: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"F.layer_norm {library_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}), max_abs_err {err:.3e} [{card}]")

    # ---- 14. planes above the fused limit: the cluster kernels, then the per-step kernels ----
    gh, gw = GRID64
    lh, lw = LARGE
    say(f"phase 14: the op forward and backward on ({P_MAIN},{gh},{gw}) planes (cluster kernels) and on "
        f"({P_MAIN},{lh},{lw}) planes (per-step kernels)")
    for dt in (torch.bfloat16, torch.float32):
        check(D.stencil_route(gh, gw, KERNEL, dt) == "cluster" and D.stencil_route(lh, lw, KERNEL, dt) == "per_step",
              f"routes of {GRID64} and {LARGE} in {dt}")

    def drive_planes(shape, dt, label):
        """The op forward and backward through the autograd Function on
        (P_MAIN, *shape) planes, the launch counts read around it; forward
        and backward held to the plain versions. Returns the tensors
        (x, w, g, step inputs), the launches and the max abs errors."""
        xl = torch.rand(P_MAIN, *shape, generator=g, device=dev).to(dt)
        wl = MD.normalize_affinity(torch.rand(P_MAIN, KERNEL ** 2, *shape, generator=g, device=dev), dim=1).to(dt)
        gl = torch.rand(P_MAIN, *shape, generator=g, device=dev).to(dt)
        xa, wa = xl.clone().requires_grad_(), wl.clone().requires_grad_()
        reset_plane_launches(D)
        out = D.diffusion_planes(xa, wa, KERNEL, STEPS)
        out.backward(gl)
        torch.cuda.synchronize()
        n = plane_launches(D)
        route = D.stencil_route(*shape, KERNEL, dt)
        per_call = STEPS if route == "per_step" else 1
        check(n == launch_tuple(route, per_call, per_call), f"{label}: launches ({LAUNCH_NAMES}) {n}")
        fp32 = dt == torch.float32
        ref = D.diffusion_planes_plain(xl.float(), wl.float(), KERNEL, STEPS)
        torch.testing.assert_close(out.detach().float(), ref, **(FP32_TOL if fp32 else dict(rtol=0, atol=BF16_ATOL)),
                                   msg=lambda m: f"{label} forward: {m}")
        errs = {"fwd": float((out.detach().float() - ref).abs().max())}
        # the backward against the plain backward on the step inputs the kernel made
        _, lxs = D._forward_steps(xl, wl, KERNEL, STEPS, keep=True)
        rdx, rdw = D.diffusion_planes_bwd_plain(gl, lxs, wl, KERNEL)
        for gname, got, want in (("dx", xa.grad, rdx), ("dw", wa.grad, rdw)):
            torch.testing.assert_close(got.float(), want.float(), **(BWD_FP32_TOL if fp32 else BWD_BF16_TOL),
                                       msg=lambda m: f"{label} {gname}: {m}")
        errs["bwd"] = max(float((xa.grad.float() - rdx.float()).abs().max()),
                          float((wa.grad.float() - rdw.float()).abs().max()))
        say(f"  {label} [{route}]: launches ({LAUNCH_NAMES}) {n}; max_abs_err forward {errs['fwd']:.3e}, "
            f"backward {errs['bwd']:.3e}")
        return (xl, wl, gl, lxs), n, errs

    # the cluster kernels at the paper's grid-64 planes, bf16 and fp32, timed
    # beside the per-step kernels called directly on the same tensors
    cluster_rows = {"fwd": {}, "bwd": {}}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        (xl, wl, gl, lxs), n, errs = drive_planes(GRID64, dt, f"{name} ({P_MAIN},{gh},{gw})")
        for part, fn, per_step, plain, match, step_match, bound in (
            ("fwd", functools.partial(D.diffusion_planes, xl, wl, KERNEL, STEPS),
             lambda xl=xl, wl=wl: D._per_step_forward(xl, wl, KERNEL, STEPS, None, torch.empty_like(xl)),
             functools.partial(D.diffusion_planes_plain, xl, wl, KERNEL, STEPS),
             "stencil_cluster_fwd", "stencil_step_kernel", stencil_bound(xl, wl, KERNEL, STEPS)),
            ("bwd", functools.partial(D.diffusion_planes_bwd, gl, lxs, wl, KERNEL),
             functools.partial(D._per_step_backward, gl, lxs, wl, KERNEL),
             functools.partial(D.diffusion_planes_bwd_plain, gl, lxs, wl, KERNEL),
             "stencil_cluster_bwd", "stencil_bwd_kernel", stencil_bwd_bound(gl, lxs, wl, KERNEL)),
        ):
            ms, per_step_ms = cuda_time_ms(fn, 100), cuda_time_ms(per_step, 50)
            plain_ms = cuda_time_ms(plain, 5, warmup=1)
            row = dict(ms=ms, per_step_ms=per_step_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                       err=errs[part], launches_per_call=n[2] if part == "fwd" else n[3])
            cluster_rows[part][name] = row
            say(f"  cluster {part} {name} ({STEPS} steps, {P_MAIN}x{gh}x{gw}, k={KERNEL}): {ms:.5f} ms per call; "
                f"per-step kernels {per_step_ms:.5f} ms per call; plain {plain_ms:.5f} ms, bound {bound[0]:.6f} ms "
                f"({bound[1]}) [{card}]")
            device_calls += [(f"cluster {part} {name}", row, "device_ms", fn, match, 50),
                             (f"per-step {part} {gh}x{gw} {name}", row, "per_step_device_ms", per_step, step_match, 50)]
    # how many clusters the card runs at once: the 8 strips of 8 rows of the
    # grid-64 plane, and a non-portable 16 strips of 4 rows
    occupancy = {}
    for part in ("fwd", "bwd"):
        for blocks, rows_per in ((8, gh // 8), (16, gh // 16)):
            try:
                occupancy[f"{part}_{blocks}"] = D.cluster_occupancy(blocks, rows_per, gw, part == "bwd")
            except RuntimeError as exc:
                occupancy[f"{part}_{blocks}"] = str(exc)
    say(f"  max active clusters (k={KERNEL}, bf16, {gh}x{gw} in 8 strips of {gh // 8} rows or 16 of {gh // 16}): "
        f"{occupancy} [{card}]")

    # the per-step kernels' own path: planes beyond the cluster's reach
    (xl, wl, gl, lxs), large_launches, large_err = drive_planes(LARGE, torch.bfloat16, f"bf16 ({P_MAIN},{lh},{lw})")
    large_rows = {}
    for name, fn, plain, match, bound in (
        ("fwd", functools.partial(D.diffusion_planes, xl, wl, KERNEL, STEPS),
         functools.partial(D.diffusion_planes_plain, xl, wl, KERNEL, STEPS),
         "stencil_step_kernel", stencil_bound(xl, wl, KERNEL, STEPS)),
        ("bwd", functools.partial(D.diffusion_planes_bwd, gl, lxs, wl, KERNEL),
         functools.partial(D.diffusion_planes_bwd_plain, gl, lxs, wl, KERNEL),
         "stencil_bwd_kernel", stencil_bwd_bound(gl, lxs, wl, KERNEL)),
    ):
        ms, plain_ms = cuda_time_ms(fn, 50), cuda_time_ms(plain, 5, warmup=1)
        large_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], err=large_err[name])
        say(f"  per-step {name} ({STEPS} steps, {P_MAIN}x{lh}x{lw}, k={KERNEL}, bf16): {ms:.5f} ms per call, "
            f"plain {plain_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}), max_abs_err {large_err[name]:.3e} [{card}]")
        device_calls.append((f"per-step {name} {lh}x{lw} bf16", large_rows[name], "device_ms", fn, match, 50))
    del xl, wl, gl, lxs
    torch.cuda.empty_cache()

    # ---- 15. cod at grid 64: served and trained through the CLIs ----
    grid = GRID64[0]
    say(f"phase 15: cod at grid {grid} (the paper's scale{grid} ablation): served through predict.main -o grid={grid} "
        f"(bf16, batch {BATCH}), trained through train.cli.main -o model.grid={grid} ({TRAIN_N} images, batch "
        f"{TRAIN_BATCH}, 1 epoch, bf16)")
    grab64 = {}

    def capture64(module, inputs, output):
        if isinstance(module, MD.MessagePassing) and "served" not in grab64:
            grab64["served"] = (inputs[0].detach().clone(), inputs[1].detach().clone())

    def spy_planes64(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        if "x" not in grab64 and out.requires_grad:
            grab64["x"], grab64["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab64.setdefault("g", gr.detach().clone()))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid64_") as tmp:
        model = cod(seed=0)
        ckpt = os.path.join(tmp, "cod_seed0.pth")
        torch.save(model.state_dict(), ckpt)
        write_inputs(tmp)
        out_dir = os.path.join(tmp, "out")
        hook = torch.nn.modules.module.register_module_forward_hook(capture64)
        try:
            reset_plane_launches(D)
            served64 = P.main(["--checkpoint", ckpt, "--image-dir", os.path.join(tmp, "img"),
                               "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", out_dir,
                               "--size", str(SIZE), "--batch", str(BATCH), "-o", f"grid={grid}"])
            torch.cuda.synchronize()
            served64_launches = plane_launches(D)
        finally:
            hook.remove()
        nb = served64["batches"]
        say(f"  served: {served64['images']} images in {nb} batches, loop {served64['loop_s']:.3f} s, stencil "
            f"launches ({LAUNCH_NAMES}) {served64_launches}")
        check(served64_launches == launch_tuple("cluster", nb), f"served grid {grid}: launches {served64_launches}")
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == N_IMAGES, outs)
        for f in outs:
            with Image.open(os.path.join(out_dir, f)) as im:
                check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        xp, wt = MD.affinity_planes(*grab64["served"], KERNEL)
        check(tuple(xp.shape) == (P_MAIN, grid, grid) and xp.dtype == torch.bfloat16, (xp.shape, xp.dtype))
        served64_err = check_kernel(D, xp, wt, KERNEL, STEPS, f"served grid {grid} bf16 stencil inputs")

        # fp32 on the card vs the same weights on the CPU (plain stencil), small input
        model32 = cod(dtype=torch.float32, seed=0, grid=grid)
        g_cpu = torch.Generator().manual_seed(3)
        img = torch.randn(1, 192, 192, 3, generator=g_cpu)
        depth = torch.rand(1, 192, 192, 1, generator=g_cpu)
        ref = model32.predict(img, depth)[0]
        reset_plane_launches(D)
        got = model32.to(dev).predict(img.to(dev), depth.to(dev))[0].cpu()
        check(plane_launches(D) == launch_tuple("cluster", 1), f"fp32 grid {grid} predict: launches {plane_launches(D)}")
        cpu64_err = float((got - ref).abs().max())
        say(f"  fp32 card vs CPU, 1x192x192 at grid {grid}: max_abs_err {cpu64_err:.3e} (limit {CPU_PROB_ATOL})")
        check(cpu64_err <= CPU_PROB_ATOL, f"grid {grid} card vs CPU {cpu64_err:.2e} > {CPU_PROB_ATOL}")
        del model32

        work = os.path.join(tmp, "run")
        overrides64 = [
            f"work_dir={work}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
            f"train_dataloader.batch_size={TRAIN_BATCH}",
            f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {TRAIN_N}, 'size': {SIZE}}}",
            "default_hooks.logger.interval=1", f"model.grid={grid}",
        ]
        MD.diffusion_planes = spy_planes64
        try:
            reset_plane_launches(D)
            trained64 = TC.main([recipe] + [a for o in overrides64 for a in ("-o", o)])
            torch.cuda.synchronize()
            train64_launches = plane_launches(D)
        finally:
            MD.diffusion_planes = planes_unspied
        steps64 = TRAIN_N // TRAIN_BATCH
        say(f"  trained: {trained64['steps']} steps in {trained64['loop_s']:.3f} s; stencil launches ({LAUNCH_NAMES}) "
            f"{train64_launches}")
        check(trained64["steps"] == steps64, trained64)
        check(train64_launches == launch_tuple("cluster", steps64, steps64),
              f"launches {train64_launches}: one cluster forward and one cluster backward a step in {steps64} steps")
        with open(os.path.join(work, "log.jsonl")) as f:
            losses64 = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        check(len(losses64) == steps64 and bool(np.isfinite(losses64).all()), losses64)
        say("  losses: " + ", ".join(f"{v:.5f}" for v in losses64))
        gx, gw64, gg = grab64["x"], grab64["w"], grab64["g"]
        check(tuple(gx.shape) == (P_TRAIN, grid, grid) and gx.dtype == torch.bfloat16, (gx.shape, gx.dtype))
        train64_err = check_bwd(D, gg, step_inputs(D, gx, gw64, KERNEL, STEPS), gw64, KERNEL,
                                f"trained grid {grid} bf16, {STEPS} steps")

        # end to end: served ms per batch and train ms per step, grid 12 and
        # grid 64 in turns (12, 64, 64, 12) on the same weights and batch
        m64 = cod(seed=None, grid=grid)
        m64.load_state_dict(model.state_dict())
        nets = {12: model.to(dev), grid: m64.to(dev)}
        g_dev = torch.Generator(device=dev).manual_seed(4)
        img = torch.randn(BATCH, SIZE, SIZE, 3, generator=g_dev, device=dev)
        depth = torch.rand(BATCH, SIZE, SIZE, 1, generator=g_dev, device=dev)
        served_turns = {12: [], grid: []}
        for gs in (12, grid, grid, 12):
            served_turns[gs].append(cuda_time_ms(lambda: nets[gs].predict(img, depth), 10, warmup=2))
        del nets, m64, model
        torch.cuda.empty_cache()
        runners = {gs: Runner(load_config(recipe, [o for o in overrides64[1:] if not o.startswith("model.grid")]
                                          + [f"model.grid={gs}"]),
                              work_dir=os.path.join(tmp, f"steps{gs}"), seed=0, device=dev, dtype=torch.bfloat16)
                   for gs in (12, grid)}
        first = next(iter(runners[grid].train_loader))
        batch = {k: first[k] for k in ("input", "label", "depth")}
        step_turns, counter = {12: [], grid: []}, [1]

        def grid_step(gs):
            r = runners[gs]
            train_step(r.model, r.optimizer, batch, counter[0], r.seed + 1)
            counter[0] += 1

        for gs in (12, grid, grid, 12):
            step_turns[gs].append(cuda_time_ms(lambda: grid_step(gs), 5, warmup=2))
        del runners, batch, first
        torch.cuda.empty_cache()
    say(f"  served bf16 ms per batch (batch {BATCH}, {SIZE}², in turns 12, {grid}, {grid}, 12): grid 12 "
        f"{served_turns[12]}, grid {grid} {served_turns[grid]} [{card}]")
    say(f"  train bf16 ms per step (batch {TRAIN_BATCH}, {SIZE}², in turns): grid 12 {step_turns[12]}, grid {grid} "
        f"{step_turns[grid]} [{card}]")

    # ---- 16. device time per call ----
    # from the profiler, read last, so that its tracing cannot touch the
    # per-call and end-to-end timings above, which are host-bound
    say("phase 16: device time per call (torch.profiler key_averages):")
    for label, row, key, fn, match, iters in device_calls:
        row[key] = device_ms(fn, iters, match)
        say(f"    {label}: {row[key] if row[key] is not None else 'no device time recorded'} ms [{card}]")
    del device_calls
    torch.cuda.empty_cache()

    b = rows["bf16"]
    bb = bwd_rows["bf16"]
    n_batches = summaries["bf16"]["batches"]
    large_shape = f"({P_MAIN},{lh},{lw}), w ({P_MAIN},{KERNEL * KERNEL},{lh},{lw}), {STEPS} steps"
    say(json.dumps({"kernels": [{
        "name": "diffusion_stencil_fused",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:263",
        "launches": launches["bf16"][0],
        "max_abs_err": b["err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
        "device_ms": b["device_ms"],
        "function_ms": b["function_ms"],
        "launch_ms": b["launch_ms"],
        "per_step_ms": b["per_step_ms"],
        "per_step_device_ms": b["per_step_device_ms"],
        "dtype": "bfloat16",
        "shape": f"x ({P_MAIN},12,12), w ({P_MAIN},{KERNEL * KERNEL},12,12), {STEPS} steps",
        "launches_per_batch": launches["bf16"][0] / n_batches,
        "launches_train": fwd_launches,
        "launches_per_step": fwd_launches / TRAIN_STEPS,
        "fp32": rows["fp32"],
        "card": card,
    }, {
        "name": "diffusion_stencil_fused_bwd",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil_bwd.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:162",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches / TRAIN_STEPS,
        "max_abs_err": train_err,
        "ms": bb["ms"],
        "plain_ms": bb["plain_ms"],
        "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"],
        "library_ms": None,
        "device_ms": bb["device_ms"],
        "launch_ms": bb["launch_ms"],
        "per_step_ms": bb["per_step_ms"],
        "per_step_device_ms": bb["per_step_device_ms"],
        "dtype": "bfloat16",
        "shape": f"g, x ({P_TRAIN},12,12), w, dw ({P_TRAIN},{KERNEL * KERNEL},12,12), {STEPS}-step backward",
        "fp32": bwd_rows["fp32"],
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": n_launch,
        "max_abs_err": max(main_err, cluster_rows[part]["bf16"]["err"]),
        "ms": cluster_rows[part]["bf16"]["ms"],
        "plain_ms": cluster_rows[part]["bf16"]["plain_ms"],
        "bound_ms": cluster_rows[part]["bf16"]["bound_ms"],
        "bound_by": cluster_rows[part]["bf16"]["bound_by"],
        "library_ms": None,
        "device_ms": cluster_rows[part]["bf16"]["device_ms"],
        "per_step_ms": cluster_rows[part]["bf16"]["per_step_ms"],
        "per_step_device_ms": cluster_rows[part]["bf16"]["per_step_device_ms"],
        "launches_per_call": cluster_rows[part]["bf16"]["launches_per_call"],
        "dtype": "bfloat16",
        "shape": f"{'x' if part == 'fwd' else 'g, step inputs, dw'} ({P_MAIN},{gh},{gw}), w ({P_MAIN},"
                 f"{KERNEL * KERNEL},{gh},{gw}), {STEPS} steps",
        "main_path": main_path,
        "max_active_clusters": {n: v for n, v in occupancy.items() if n.startswith(part)},
        "fp32": cluster_rows[part]["fp32"],
        "card": card,
    } for name, source, replaces, part, n_launch, main_err, main_path in (
        ("diffusion_stencil_cluster", "diffusion_stencil", "dgtd_tpu/ops/diffusion_pallas.py:263", "fwd",
         served64_launches[2], served64_err,
         f"{served64_launches[2]} launches in {nb} served batches and {train64_launches[2]} in {steps64} train "
         f"steps of cod at grid {grid}"),
        ("diffusion_stencil_cluster_bwd", "diffusion_stencil_bwd", "dgtd_tpu/ops/diffusion_pallas.py:162", "bwd",
         train64_launches[3], train64_err,
         f"{train64_launches[3]} launches in {steps64} train steps of cod at grid {grid}"),
    )] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": n_launch,
        "max_abs_err": large_rows[part]["err"],
        "ms": large_rows[part]["ms"],
        "plain_ms": large_rows[part]["plain_ms"],
        "bound_ms": large_rows[part]["bound_ms"],
        "bound_by": large_rows[part]["bound_by"],
        "library_ms": None,
        "device_ms": large_rows[part]["device_ms"],
        "dtype": "bfloat16",
        "shape": f"{'x' if part == 'fwd' else 'g, step inputs, dw'} {large_shape}",
        "card": card,
    } for name, source, replaces, part, n_launch in (
        ("diffusion_stencil", "diffusion_stencil", "dgtd_tpu/ops/diffusion_pallas.py:263", "fwd", large_launches[4]),
        ("diffusion_stencil_bwd", "diffusion_stencil_bwd", "dgtd_tpu/ops/diffusion_pallas.py:162", "bwd", large_launches[5]),
    )] + [{
        "name": "diffusion_stencil_nhwc",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:55",
        "launches": nhwc_launches[0],
        "max_abs_err": nhwc_rows["bf16"]["err"],
        "ms": nhwc_rows["bf16"]["ms"],
        "plain_ms": nhwc_rows["bf16"]["plain_ms"],
        "bound_ms": nhwc_rows["bf16"]["bound_ms"],
        "bound_by": nhwc_rows["bf16"]["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"x (8,12,12,24), w (8,12,12,{KERNEL * KERNEL}*24) tap-major, {STEPS} steps",
        "backward_launches": nhwc_launches[1],
        "grad_max_abs_err": nhwc_grad_err,
        "fp32": nhwc_rows["fp32"],
        "card": card,
    }, {
        "name": "layer_norm",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/layernorm.cu",
        "replaces": "dgtd_tpu/ops/layernorm_pallas.py:50",
        "launches": ln_launches,
        "max_abs_err": ln_rows["pvt_b2_stage1"]["err"],
        "ms": ln_rows["pvt_b2_stage1"]["ms"],
        "plain_ms": ln_rows["pvt_b2_stage1"]["plain_ms"],
        "bound_ms": ln_rows["pvt_b2_stage1"]["bound_ms"],
        "bound_by": ln_rows["pvt_b2_stage1"]["bound_by"],
        "library_ms": ln_rows["pvt_b2_stage1"]["library_ms"],
        "dtype": "bfloat16",
        "shape": "x (8*96*96, 64)",
        "convnext_b_stage1": ln_rows["convnext_b_stage1"],
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{'msda_fwd' if name == 'msda_fwd' else 'msda_bwd'}.cu",
        "replaces": replaces,
        "launches": msda_launches[name],
        "max_abs_err": msda_rows[name]["err"],
        "ms": msda_rows[name]["ms"],
        "plain_ms": msda_rows[name]["plain_ms"],
        "bound_ms": msda_rows[name]["bound_ms"],
        "bound_by": msda_rows[name]["bound_by"],
        "library_ms": None,
        "dtype": "float32",
        "shape": f"value ({ENC_N},{ENC_S},{ENC_HEADS},{ENC_D_MODEL // ENC_HEADS}), Lq {ENC_S}, levels {ENC_SHAPES}, {ENC_POINTS} points",
        "card": card,
    } for name, replaces in (("msda_fwd", "dgtd_tpu/ops/msda.py:165"), ("msda_dvalue", "dgtd_tpu/ops/msda.py:255"),
                             ("msda_dlocw", "dgtd_tpu/ops/msda.py:353"))]}))
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
    say(json.dumps({"grid64": {
        "model": f"cod, full width, seeded random weights, grid {grid} (-o grid={grid} / -o model.grid={grid})",
        "size": SIZE,
        "served": {"batch": BATCH, "batches": nb, "launches": served64_launches, "loop_s": served64["loop_s"],
                   "fp32_card_vs_cpu": cpu64_err},
        "trained": {"batch": TRAIN_BATCH, "steps": trained64["steps"], "launches": train64_launches,
                    "losses": losses64, "loop_s": trained64["loop_s"]},
        "launch_order": LAUNCH_NAMES,
        "served_ms_per_batch": {"grid12": served_turns[12], f"grid{grid}": served_turns[grid]},
        "train_ms_per_step": {"grid12": step_turns[12], f"grid{grid}": step_turns[grid]},
        "card": card,
    }}))
    say(json.dumps({"msda": {
        "layer": f"MSDeformAttn(d_model={ENC_D_MODEL}, n_levels={len(ENC_SHAPES)}, n_heads={ENC_HEADS}, "
                 f"n_points={ENC_POINTS}), seeded weights",
        "n": ENC_N, "lq": ENC_S, "levels": ENC_SHAPES,
        "iterations": ENC_ITERS, "launches": msda_launches,
        "op_fwd_ms": op_fwd_ms, "op_bwd_ms": op_bwd_ms, "op_fwd_bwd_ms": op_step_ms,
        "layer_iteration_ms": layer_step_ms,
        "card_vs_cpu_rel": layer_errs,
        "card": card,
    }}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
