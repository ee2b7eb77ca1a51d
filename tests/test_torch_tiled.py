"""The tiled stencil kernels' plan and schedule, on the CPU.

``ops/diffusion.py::tiled_plan`` mirrors ``csrc/stencil_common.cuh``'s plan
of the tiled kernels (temporal blocking: one block a tile of a plane, all
the steps of a call in one launch, the halo recomputed). The plan is pinned
at the planes that take the tiled route, and a plain-PyTorch emulation of
the kernels' schedule, tile by tile with the same regions and halos, is
held to the untiled plain versions: forward, saved step inputs, dx and dw.
That proves the halo arithmetic without a card; the kernels themselves are
held to the plain versions on the card by tests/test_torch_kernels.py and
chip_smoke.py.

This file imports neither JAX nor ``dgtd_tpu``.
"""

import pytest
import torch
import torch.nn.functional as F

from dgtd_tpu_torch.ops import diffusion as D

BF, F32 = torch.bfloat16, torch.float32


# (h, w, k, dtype) -> (forward plan, backward plan) at 4 steps, each (tile
# rows, tile columns, ws mode): the kernel9 and kernel11 ablations' 12x12
# planes (one tile, no recomputed halo), grids beyond a cluster's reach
# (96², serving_check's 512²), a row wider than a tile, a column of 4097
# pixels and 17 x 241 (4097 pixels). The forward never stages w (ws).
PLANS = {
    (12, 12, 9, BF): ((12, 12, False), (12, 12, True)),
    (12, 12, 9, F32): ((12, 12, False), (12, 12, True)),
    (12, 12, 11, BF): ((12, 12, False), (12, 12, True)),
    (12, 12, 11, F32): ((12, 12, False), (12, 12, True)),
    (96, 96, 7, BF): ((20, 96, False), (20, 96, False)),
    (96, 96, 7, F32): ((20, 96, False), (20, 96, False)),
    (96, 96, 11, BF): ((20, 96, False), (14, 96, False)),
    (512, 512, 7, BF): ((43, 47, False), (43, 47, False)),
    (512, 512, 7, F32): ((43, 47, False), (43, 47, False)),
    (1, 4096, 7, BF): ((1, 1366, False), (1, 683, True)),
    (1, 4096, 7, F32): ((1, 1366, False), (1, 586, True)),
    (4097, 1, 7, BF): ((241, 1, False), (241, 1, True)),
    (4097, 1, 7, F32): ((241, 1, False), (241, 1, True)),
    (17, 241, 7, BF): ((17, 81, False), (17, 61, True)),
    (17, 241, 7, F32): ((17, 81, False), (17, 81, False)),
}


@pytest.mark.parametrize("key", list(PLANS), ids=[f"{h}x{w}k{k}{str(d)[6:]}" for h, w, k, d in PLANS])
def test_tiled_route_and_plan(key):
    h, w, k, dtype = key
    fwd, bwd = PLANS[key]
    assert D.stencil_route(h, w, k, dtype) == "tiled"
    assert D.plane_route(h, w, k, dtype, 4) == "tiled"
    assert D.tiled_plan(h, w, k, 4, dtype) == fwd
    assert D.tiled_plan(h, w, k, 4, dtype, True) == bwd
    for plan, bwd_flag in ((fwd, False), (bwd, True)):
        th, tw, ws = plan
        assert D.tiled_smem(th, tw, h, w, k, 4, dtype.itemsize, bwd_flag, ws) <= D.FUSED_SMEM_LIMIT
        if not ws:
            assert th * tw <= D.TILED_STREAM_MAX_PIXELS
            assert D.tiled_smem(th, tw, h, w, k, 4, dtype.itemsize, bwd_flag, ws) <= D.TILED_STREAM_SMEM


def test_tiled_plan_one_tile_has_no_recomputed_halo():
    """A plane that one tile holds is computed once: the kernel11 ablation's
    12x12 planes read w once (the tile's w region is the plane); the
    backward stages it for its later steps."""
    for k in (9, 11):
        for dtype in (BF, F32):
            for bwd in (False, True):
                assert D.tiled_plan(12, 12, k, 4, dtype, bwd) == (12, 12, bwd)


#: planes of the tiled route: the ablations' 12², 96², 512², a long row and
#: column, 17 x 241
WS_PLANES = [(12, 12, 11), (12, 12, 9), (96, 96, 7), (512, 512, 7), (1, 4096, 7), (4097, 1, 7), (17, 241, 7)]


@pytest.mark.parametrize("h,w,k", WS_PLANES, ids=[f"{h}x{w}k{k}" for h, w, k in WS_PLANES])
def test_tiled_plan_stages_w_only_in_a_backward_of_several_steps(h, w, k):
    """ws mode (w staged in shared memory by the first step for the later
    ones) is the backward's, at 2 or more steps: the forward streams w at
    every step, and at one step no later step would read what was staged.
    The 1-step plans stream w in tiles of two blocks an SM."""
    for dtype in (BF, F32):
        for steps in (1, 2, 4, 6):
            assert D.tiled_plan(h, w, k, steps, dtype)[2] is False
        for bwd in (False, True):
            th, tw, ws = D.tiled_plan(h, w, k, 1, dtype, bwd)
            assert not ws and th * tw <= D.TILED_STREAM_MAX_PIXELS
            assert D.tiled_smem(th, tw, h, w, k, 1, dtype.itemsize, bwd, False) <= D.TILED_STREAM_SMEM


def test_routes_beyond_the_tiled_kernels():
    """k = 13 has no tiled template: the per-step route; k = 11 beyond 16
    steps on a plane that one tile does not hold has no tile that fits: the
    per-step route for that call."""
    assert D.stencil_route(96, 96, 13, BF) == "per_step"
    assert D.tiled_plan(96, 96, 13, 4, BF) is None
    assert D.plane_route(512, 512, 11, BF, 16) == "tiled"
    assert D.plane_route(512, 512, 11, BF, 17) == "per_step"
    assert D.plane_route(12, 12, 11, BF, 17) == "tiled"


# ---------------------------------------------------------------------------
# the kernels' schedule, emulated tile by tile
# ---------------------------------------------------------------------------


def _tiles(h, w, th, tw):
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            yield y0, min(y0 + th, h), x0, min(x0 + tw, w)


def _box(lo, hi, grow, n, edge):
    """[lo - grow, hi + grow) within `edge` of [0, n)."""
    return max(lo - grow, -edge), min(hi + grow, n + edge)


def _load(t, y0, y1, x0, x1):
    """t (P, H, W) on rows [y0, y1) and columns [x0, x1), zero beyond it."""
    p, h, w = t.shape
    out = torch.zeros(p, y1 - y0, x1 - x0, dtype=torch.float32)
    ys, ye, xs, xe = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
    out[:, ys - y0 : ye - y0, xs - x0 : xe - x0] = t[:, ys:ye, xs:xe].float()
    return out


def _round(v, dtype):
    return v.to(dtype).float()


def tiled_forward_emulated(x, w, k, steps, plan):
    """The tiled forward's schedule: for each tile, x on the interior grown
    by steps·r (the plane's zero edge beyond it) in a fp32 buffer; step s
    computes the interior grown by (steps-1-s)·r within the plane from the
    buffer, rounded to x's dtype; the interior's step inputs and the last
    step's output are kept. Returns (out, xs)."""
    p, h, wd = x.shape
    r, (th, tw, _) = k // 2, plan
    out = torch.empty_like(x)
    xs = torch.empty((steps, p, h, wd), dtype=x.dtype)
    for y0, y1, x0, x1 in _tiles(h, wd, th, tw):
        by0, by1 = _box(y0, y1, steps * r, h, r)
        bx0, bx1 = _box(x0, x1, steps * r, wd, r)
        src = _load(x, by0, by1, bx0, bx1)
        xs[0, :, y0:y1, x0:x1] = x[:, y0:y1, x0:x1]
        for s in range(steps):
            e = (steps - 1 - s) * r
            cy0, cy1 = _box(y0, y1, e, h, 0)
            cx0, cx1 = _box(x0, x1, e, wd, 0)
            win = src[:, cy0 - r - by0 : cy1 + r - by0, cx0 - r - bx0 : cx1 + r - bx0]
            taps = F.unfold(win.unsqueeze(1), k).view(p, k * k, cy1 - cy0, cx1 - cx0)
            acc = (taps * w[:, :, cy0:cy1, cx0:cx1].float()).sum(1)
            inner = acc[:, y0 - cy0 : y1 - cy0, x0 - cx0 : x1 - cx0]
            if s == steps - 1:
                out[:, y0:y1, x0:x1] = inner.to(x.dtype)
                continue
            xs[s + 1, :, y0:y1, x0:x1] = inner.to(x.dtype)
            dst = torch.zeros_like(src)  # the stale cells of the other buffer are never read
            dst[:, cy0 - by0 : cy1 - by0, cx0 - bx0 : cx1 - bx0] = _round(acc, x.dtype)
            src = dst
    return out, xs


def tiled_backward_emulated(g, xs, w, k, plan):
    """The tiled backward's schedule: for each tile, g on the interior grown
    by steps·r; step s in reverse keeps the interior of its output's
    gradient and forms its input's gradient on the interior grown by s·r
    within the plane (the transpose stencil from the region grown by r,
    rounded to g's dtype); dw on the interior after the step loop, each
    step's product summed last step first, cast to w's dtype once."""
    steps, p, h, wd = xs.shape
    r, kk, (th, tw, _) = k // 2, k * k, plan
    dx = torch.empty_like(g)
    dw = torch.empty_like(w)
    for y0, y1, x0, x1 in _tiles(h, wd, th, tw):
        by0, by1 = _box(y0, y1, steps * r, h, r)
        bx0, bx1 = _box(x0, x1, steps * r, wd, r)
        src = _load(g, by0, by1, bx0, bx1)
        ghist = [None] * steps
        for s in range(steps - 1, -1, -1):
            ghist[s] = src[:, y0 - by0 : y1 - by0, x0 - bx0 : x1 - bx0]
            e = s * r
            cy0, cy1 = _box(y0, y1, e, h, 0)
            cx0, cx1 = _box(x0, x1, e, wd, 0)
            uy0, uy1, ux0, ux1 = cy0 - r, cy1 + r, cx0 - r, cx1 + r  # the sources of the region's taps
            gu = src[:, uy0 - by0 : uy1 - by0, ux0 - bx0 : ux1 - bx0]
            wu = torch.stack([_load(w[:, t], uy0, uy1, ux0, ux1) for t in range(kk)], 1)
            folded = F.fold((gu.unsqueeze(1) * wu).reshape(p, kk, -1), (uy1 - uy0 + 2 * r, ux1 - ux0 + 2 * r), k)
            d = folded.view(p, uy1 - uy0 + 2 * r, ux1 - ux0 + 2 * r)[:, 2 * r : -2 * r or None, 2 * r : -2 * r or None]
            if s == 0:
                dx[:, y0:y1, x0:x1] = d[:, y0 - cy0 : y1 - cy0, x0 - cx0 : x1 - cx0].to(g.dtype)
                continue
            dst = torch.zeros_like(src)
            dst[:, cy0 - by0 : cy1 - by0, cx0 - bx0 : cx1 - bx0] = _round(d, g.dtype)
            src = dst
        acc = None
        for s in range(steps - 1, -1, -1):
            taps = F.unfold(_load(xs[s], y0 - r, y1 + r, x0 - r, x1 + r).unsqueeze(1), k)
            prod = ghist[s].unsqueeze(1) * taps.view(p, kk, y1 - y0, x1 - x0)
            acc = prod if acc is None else acc + prod
        dw[:, :, y0:y1, x0:x1] = acc.to(w.dtype)
    return dx, dw


def _planes(seed, p, h, w, k):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(p, h, w, generator=g)
    raw = torch.rand(p, k * k, h, w, generator=g)
    return x, raw / (raw.sum(1, keepdim=True) + 1e-5), torch.rand(p, h, w, generator=g)


#: (h, w, k, steps, plan): each plane's own plan where it is cheap to
#: emulate, and forced tiles (the backward's ws mode does not change the
#: values) that put
#: halos across tile edges on small planes: ragged tiles, a 1-row plane, a
#: column, 6 steps, tiles narrower than the halo, k = 9 and 11
EMULATED = [
    (12, 12, 11, 4, None), (12, 12, 9, 4, None), (96, 96, 7, 4, None), (17, 241, 7, 4, None), (4097, 1, 7, 4, None),
    (17, 23, 3, 4, (5, 7, False)), (19, 20, 7, 6, (6, 9, False)), (1, 70, 5, 4, (1, 16, True)),
    (70, 1, 3, 3, (9, 1, True)), (25, 31, 11, 3, (8, 11, False)), (23, 26, 9, 2, (10, 6, True)),
    (13, 20, 1, 4, (4, 7, False)), (30, 30, 5, 1, (7, 8, True)),
]


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("h,w,k,steps,plan", EMULATED, ids=[f"{c[0]}x{c[1]}k{c[2]}s{c[3]}" for c in EMULATED])
def test_tiled_schedule_equals_untiled_plain(h, w, k, steps, plan, dtype):
    """The emulated tiled forward and backward equal the plain versions:
    fp32 to 1e-6; bf16 rounds every step as the plain version does, to the
    same tolerance of the values it rounds."""
    p = 2
    x, wt, g = (t.to(dtype) for t in _planes(h * 31 + w + k, p, h, w, k))
    fwd_plan = plan or D.tiled_plan(h, w, k, steps, dtype)
    bwd_plan = plan or D.tiled_plan(h, w, k, steps, dtype, True)
    out, xs = tiled_forward_emulated(x, wt, k, steps, fwd_plan)
    ref_xs = [x]
    for _ in range(steps):
        ref_xs.append(D.diffusion_step_plain(ref_xs[-1], wt, k))
    tol = dict(rtol=0, atol=1e-6) if dtype == F32 else dict(rtol=2 ** -8, atol=1e-6)
    torch.testing.assert_close(out.float(), ref_xs[-1].float(), **tol)
    torch.testing.assert_close(xs.float(), torch.stack(ref_xs[:-1]).float(), **tol)
    dx, dw = tiled_backward_emulated(g, xs, wt, k, bwd_plan)
    rdx, rdw = D.diffusion_planes_bwd_plain(g, list(xs), wt, k)
    assert dx.dtype == dw.dtype == dtype
    torch.testing.assert_close(dx.float(), rdx.float(), **tol)
    torch.testing.assert_close(dw.float(), rdw.float(), **tol)


def test_profile_stencil_counts_the_w_the_tiles_read():
    """tools/profile_stencil.py's count of the w bytes the tiles read: one
    tile a plane reads its w once a step; row strips of 96² at k = 7 read
    each strip's rows grown by the step's halo, within the plane."""
    from dgtd_tpu_torch.tools.profile_stencil import tiled_w_reads

    plane = 121 * 12 * 12 * 2
    assert tiled_w_reads(12, 12, 11, 4, BF, False) == tiled_w_reads(12, 12, 11, 4, BF, True) == 4 * plane
    th, tw, _ = D.tiled_plan(96, 96, 7, 4, BF)
    assert (th, tw) == (20, 96)
    rows = 0
    for y0 in range(0, 96, th):
        for t in range(4):
            grow = (3 - t) * 3
            rows += min(y0 + th + grow, 96) - max(y0 - grow, 0)
    assert tiled_w_reads(96, 96, 7, 4, BF, False) == rows * 96 * 49 * 2
