"""Where the multi-scale deformable attention kernels' time goes on the GPU.

At Deformable DETR's encoder shape (``MSDeformAttn(256)``: 8 heads of 32
channels, 4 levels 64²/32²/16²/8², 4 points; N = 2, Lq = S = 5440, seeded
weights) it times the forward, dValue and dLocation/dWeight kernels in fp32
and in bf16 (value and output gradient), each by CUDA events over calls
back to back and by ``torch.profiler``'s device time per launch, on two
sets of locations that the layer makes from its own offsets:
  * random-reference: reference points uniform at random per query, as
    ``chip_smoke.py``'s phase 11 captures the layer's tensors;
  * encoder-grid: each level's pixel centres, each query's own point copied
    to every level, as Deformable DETR's encoder computes them (valid
    ratios 1).
For each set it prints the bytes of in-range corner rows that the gather
moves, split into the levels that the kernels' plan (``ops/msda.py::msda_plan``)
stages in shared memory and the others, which come through L2; the bytes
the blocks stage; and the mean number of distinct corner rows per
(n, q, m). For dValue it prints its own plan (fp32 accumulator rows) and
its adds: element adds into shared memory on the staged levels, adds into
the gradient through L2 on the others (16 bytes each on the vector route),
and the adds of the blocks' flush; and it times dValue again on a plan
that stages nothing (every add through L2; the zeroing of its buffer is
in the CUDA-event time, not in the device time). It also times the reference's per-level
``F.grid_sample`` composition on the same fp32 tensors, a yardstick only.

    python -m dgtd_tpu_torch.tools.profile_msda [--iters 100]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ..ops import msda as A

ENC_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
ENC_N, ENC_D_MODEL, ENC_HEADS, ENC_POINTS = 2, 256, 8, 4
ENC_S = sum(h * w for h, w in ENC_SHAPES)
KERNELS = ("msda_fwd", "msda_dvalue", "msda_dlocw", "msda_dvalue_unstaged")


def encoder_grid_refs(shapes, n: int) -> torch.Tensor:
    """(n, S, L, 2) reference points in (x, y): query q at its own pixel's
    centre on its own level, ((j + 0.5) / W, (i + 0.5) / H), the same point
    on every level."""
    pts = []
    for h, w in shapes:
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        pts.append(torch.stack(((xs.reshape(-1) + 0.5) / w, (ys.reshape(-1) + 0.5) / h), -1))
    refs = torch.cat(pts, 0)
    return refs[None, :, None, :].expand(n, -1, len(shapes), 2).contiguous()


def layer_inputs(seed: int = 11):
    """query, value and the random reference points as phase 11 of
    chip_smoke.py draws them (its target is drawn and dropped here), numpy."""
    rng = np.random.RandomState(seed)
    query = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    value = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    rng.randn(ENC_N, ENC_S, ENC_D_MODEL)
    refs = rng.rand(ENC_N, ENC_S, len(ENC_SHAPES), 2).astype(np.float32)
    return query, value, refs


def corner_rows(loc: torch.Tensor, shapes) -> torch.Tensor:
    """(N, Lq, M, L, P, 4) the row of value (start_l + y·W_l + x) that each
    bilinear corner reads, -1 where the corner lies off its level; the
    coordinates rounded as the kernels round them (product, then
    difference)."""
    rows, start = [], 0
    for lid, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5).long()
        corners = []
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                corners.append(torch.where(inside, start + yi * w + xi, torch.full_like(xi, -1)))
        rows.append(torch.stack(corners, -1))
        start += h * w
    return torch.stack(rows, 3)


def gather_counts(loc: torch.Tensor, shapes, d: int, itemsize: int, staged) -> dict:
    """Bytes of the in-range corner rows (d·itemsize each) gathered from the
    staged levels and from the others, and the mean number of distinct rows
    per (n, q, m)."""
    rows = corner_rows(loc, shapes)
    inside = rows >= 0
    per_level = inside.sum(dim=(0, 1, 2, 4, 5))
    on_chip = sum(int(per_level[lid]) for lid in staged)
    flat = rows.flatten(3).sort(-1).values
    fresh = torch.ones_like(flat, dtype=torch.bool)
    fresh[..., 1:] = flat[..., 1:] != flat[..., :-1]
    distinct = (fresh & (flat >= 0)).sum(-1)
    row_bytes = d * itemsize
    return {"corner_bytes_staged": on_chip * row_bytes,
            "corner_bytes_unstaged": (int(per_level.sum()) - on_chip) * row_bytes,
            "distinct_rows_per_query_head": float(distinct.float().mean())}


def corner_weights(loc: torch.Tensor, shapes) -> torch.Tensor:
    """(N, Lq, M, L, P, 4) each bilinear corner's x weight * y weight, the
    coordinates rounded as the kernels round them; corner order as
    :func:`corner_rows`."""
    out = []
    for lid, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lid, :, 0] * w - 0.5
        y = loc[:, :, :, lid, :, 1] * h - 0.5
        fx, fy = x - torch.floor(x), y - torch.floor(y)
        out.append(torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1))
    return torch.stack(out, 3)


def dvalue_counts(loc: torch.Tensor, aw: torch.Tensor, shapes, d: int, plan) -> dict:
    """dValue's adds on these locations under its plan (``msda_plan(...,
    accumulate=True)``): element adds into shared memory (the in-range
    corners on the staged levels, d each); adds into the gradient through
    L2 (the in-range corners on the other levels, d/4 16-byte adds each on
    the vector route, else d element adds); and the flush's adds through L2
    (each block's distinct staged rows with a nonzero corner weight, in
    16-byte or element adds: the kernel skips the chunks no sample
    touched). A block is one (n, m) head and a chunk of its queries."""
    n, lq, m = loc.shape[:3]
    rows = corner_rows(loc, shapes)
    live = (corner_weights(loc, shapes) != 0) & (aw[..., None] != 0) & (rows >= 0)
    staged = torch.zeros(len(shapes), dtype=torch.bool, device=loc.device)
    staged[list(plan.staged)] = True
    on_chip = staged[None, None, None, :, None, None].expand_as(rows)
    per_row = d // 4 if plan.vec > 1 else d
    inside = rows >= 0
    per = -(-lq // plan.chunks)
    block = ((torch.arange(n, device=loc.device)[:, None, None] * m + torch.arange(m, device=loc.device))
             * plan.chunks + (torch.arange(lq, device=loc.device) // per)[None, :, None])  # (N, Lq, M)
    s_len = sum(h * w for h, w in shapes)
    keys = (block[:, :, :, None, None, None].expand_as(rows) * s_len + rows)[live & on_chip]
    return {"shared_adds": int((inside & on_chip).sum()) * d,
            "global_adds": int((inside & ~on_chip).sum()) * per_row,
            "flush_adds": int(torch.unique(keys).numel()) * per_row,
            "global_add_bytes": 16 if plan.vec > 1 else 4}


def grid_sample_composition(value, shapes, loc, aw):
    """The reference's ``ms_deform_attn_core_pytorch``: one ``F.grid_sample``
    a level, then the weighted sum. A yardstick, on no path of the port."""
    n, s, m, d = value.shape
    _, lq, _, n_levels, p, _ = loc.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
    a = aw.transpose(1, 2).reshape(n * m, 1, lq, n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1).view(n, m * d, lq)
    return out.transpose(1, 2).contiguous()


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call over ``iters`` calls back to back, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match: str, iters: int):
    """Device ms per launch of the kernel whose name holds ``match`` (each
    kernel here launches once a call), from ``torch.profiler`` over
    ``iters`` calls, and the launches it recorded (it may drop some); None
    if it recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if match in e.key]
    launches = sum(e.count for e in found)
    return (sum(e.device_time_total for e in found) / 1e3 / launches if launches else None), launches


def location_sets(dev):
    """{"random_reference": (v, loc, aw), "encoder_grid": (v, loc, aw)}, the
    op's fp32 inputs from the seeded layer (TF32 off), and the output
    gradient as phase 11 draws it."""
    query, value, refs = layer_inputs()
    layer = A.MSDeformAttn(ENC_D_MODEL, len(ENC_SHAPES), ENC_HEADS, ENC_POINTS, seed=0).to(dev)
    q, v = torch.from_numpy(query).to(dev), torch.from_numpy(value).to(dev)
    sets = {}
    with torch.no_grad():
        for name, r in (("random_reference", torch.from_numpy(refs)),
                        ("encoder_grid", encoder_grid_refs(ENC_SHAPES, ENC_N))):
            sets[name] = tuple(t.contiguous() for t in layer.sampling(q, r.to(dev), v, ENC_SHAPES))
    g = torch.from_numpy(np.random.RandomState(12).rand(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)).to(dev)
    return sets, g


def profile_set(v, loc, aw, g, dtype, iters: int) -> dict:
    v, g = v.to(dtype), g.to(dtype)
    n, s, m, d = v.shape
    plan = A.msda_plan(ENC_SHAPES, n, loc.shape[1], m, d, ENC_POINTS, dtype)
    dv_plan = A.msda_plan(ENC_SHAPES, n, loc.shape[1], m, d, ENC_POINTS, dtype, accumulate=True)
    row = {"plan": plan._asdict(), **gather_counts(loc, ENC_SHAPES, d, v.element_size(), plan.staged),
           "staging_bytes": n * m * plan.chunks * plan.smem_bytes,
           "dvalue_plan": dv_plan._asdict(), "dvalue_adds": dvalue_counts(loc, aw, ENC_SHAPES, d, dv_plan)}
    calls = {
        "msda_fwd": lambda: A.ms_deform_attn_fwd(v, ENC_SHAPES, loc, aw),
        "msda_dvalue": lambda: A.ms_deform_attn_dvalue(g, v, ENC_SHAPES, loc, aw),
        "msda_dlocw": lambda: A.ms_deform_attn_dlocw(g, v, ENC_SHAPES, loc, aw),
    }
    # dValue on a plan that stages nothing: every add through L2, as 16-byte
    # reductions (what its shared-memory accumulators save)
    unstaged = dv_plan._replace(staged=(), smem_bytes=0, chunks=-(-loc.shape[1] // (A.THREADS // 32)))
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    calls["msda_dvalue_unstaged"] = lambda: A._dvalue_launch(g, v, ENC_SHAPES, loc, aw, dv.zero_(), unstaged)
    for name, fn in calls.items():
        dev, launches = device_ms(fn, "msda_dvalue_kernel" if name == "msda_dvalue_unstaged" else f"{name}_kernel",
                                  iters)
        row[name] = {"ms": cuda_ms(fn, iters), "device_ms": dev, "profiled_launches": launches}
    if dtype == torch.float32:  # grid_sample takes its grid in the input's dtype
        row["grid_sample_ms"] = cuda_ms(lambda: grid_sample_composition(v, ENC_SHAPES, loc, aw), 10, warmup=2)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_msda needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sets, g = location_sets(dev)
    rows = {}
    for set_name, (v, loc, aw) in sets.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{set_name}/{str(dtype).split('.')[-1]}"
            row = rows[key] = profile_set(v, loc, aw, g, dtype, args.iters)
            total = row["corner_bytes_staged"] + row["corner_bytes_unstaged"]
            print(f"{key}: plan staged levels {row['plan']['staged']}, {row['plan']['vec']} channels a load, "
                  f"{row['plan']['chunks']} chunks a head; corner rows {total / 1e6:.1f} MB "
                  f"({row['corner_bytes_staged'] / 1e6:.1f} MB staged levels, {row['corner_bytes_unstaged'] / 1e6:.1f} MB "
                  f"the others), staging {row['staging_bytes'] / 1e6:.1f} MB, "
                  f"{row['distinct_rows_per_query_head']:.2f} distinct rows per (n, q, m) [{card}]")
            adds = row["dvalue_adds"]
            print(f"  dValue plan: staged levels {row['dvalue_plan']['staged']} (fp32 rows, "
                  f"{row['dvalue_plan']['smem_bytes']} bytes), {row['dvalue_plan']['vec']} channels a load, "
                  f"{row['dvalue_plan']['chunks']} chunks a head; adds: {adds['shared_adds'] / 1e6:.2f}M into shared "
                  f"memory, {adds['global_adds'] / 1e6:.2f}M through L2 ({adds['global_add_bytes']} bytes each), "
                  f"flush {adds['flush_adds'] / 1e6:.3f}M")
            for name in KERNELS:
                dev_ms = row[name]["device_ms"]
                print(f"  {name}: {row[name]['ms']:.5f} ms, device {dev_ms if dev_ms is None else f'{dev_ms:.5f}'} ms "
                      f"({row[name]['profiled_launches']} of {args.iters} launches recorded)")
            if "grid_sample_ms" in row:
                print(f"  grid_sample composition (yardstick): {row['grid_sample_ms']:.5f} ms")
        torch.cuda.empty_cache()
    summary = {"profile_msda": rows, "card": card}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
