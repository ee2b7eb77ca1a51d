"""The port's CUDA stencil and LayerNorm wrappers: dispatch, refusals, the
route predicate (fused, cluster, tiled, per-step) and the cluster kernels'
strip split, the NHWC kernels' route and plan, and (on a card) the plane
stencil's fused, cluster, tiled and per-step kernels forward and backward,
the NHWC tiled and per-step kernels and the LayerNorm kernel against their
plain versions, and the val pass's per-image metric
statistics (``metrics/device.py::batch_statistics``, plain PyTorch) on the
card against the CPU.

This file imports neither JAX nor ``dgtd_tpu``, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py``
(the ``cuda``-marked tests skip without a card).
"""

import numpy as np
import pytest
import torch

from dgtd_tpu_torch.metrics.device import batch_statistics, statistics_to_host
from dgtd_tpu_torch.models.diffusion import affinity_planes
from dgtd_tpu_torch.ops import diffusion as D
from dgtd_tpu_torch.ops import layernorm as L

# fp32: the kernel's FMA chain vs unfold·w·sum, a few ulps of O(1) values
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16: the kernel rounds to bf16 after each of 4 steps; inputs in [0, 1)
# and convex weights keep each rounding under 2^-9, so s steps drift up to
# s·2^-9 from the plain version in fp32 (bf16_atol)
BF16_ATOL = 1e-2
# backward, bf16: kernel and plain both sum in fp32 and round to bf16, so a
# rounding can flip one ulp (2^-7 relative); chains round dx every step
BWD_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_atol(steps):
    return max(BF16_ATOL, steps * 2 ** -9)


def _planes(seed, p, h, w, k, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(p, h, w, generator=g)
    raw = torch.rand(p, k * k, h, w, generator=g)
    return x.to(device), (raw / (raw.sum(1, keepdim=True) + 1e-5)).to(device)


def _plane_launches():
    """fused forward, fused backward, cluster forward, cluster backward,
    per-step forward, per-step backward, tiled forward, tiled backward"""
    return (D.FUSED_LAUNCHES, D.FUSED_BWD_LAUNCHES, D.CLUSTER_LAUNCHES, D.CLUSTER_BWD_LAUNCHES,
            D.LAUNCHES, D.BWD_LAUNCHES, D.TILED_LAUNCHES, D.TILED_BWD_LAUNCHES)


_SLOTS = {"fused": 0, "cluster": 2, "per_step": 4, "tiled": 6}


def _expected_launches(before, route, steps, bwd):
    """The counters after one call of ``steps`` steps (forward, or backward
    when ``bwd``) on a plane of this route: one fused, cluster or tiled
    launch for all the steps, or one per-step launch a step."""
    slot = _SLOTS[route] + int(bwd)
    add = [0] * 8
    add[slot] = steps if route == "per_step" else int(steps > 0)
    return tuple(b + a for b, a in zip(before, add))


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    x, w = _planes(0, 2, 5, 6, 3)
    before = _plane_launches()
    out = D.diffusion_planes(x, w, 3, 2)
    assert _plane_launches() == before
    torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, 3, 2), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k,fused", [
    (12, 12, 7, True),  # the cod recipe's grid
    (13, 20, 7, True),  # the test grid
    (16, 32, 7, True),  # 512 pixels, the limit
    (1, 512, 7, True),  # the largest padded planes within the limit
    (12, 12, 1, True), (12, 12, 3, True), (12, 12, 5, True),
    (23, 23, 7, False),  # 529 pixels, just above the limit
    (64, 64, 7, False),  # the JAX package's Pallas grid
    (1, 513, 1, False),
    (12, 12, 9, False),  # k not a template argument of the fused kernels
])
def test_fused_path_predicate(h, w, k, fused, dtype):
    assert D.fused_path(h, w, k, dtype) is fused


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k,route", [
    (12, 12, 7, "fused"),  # the cod recipe's grid
    (22, 22, 7, "fused"),  # 484 pixels
    (23, 23, 7, "cluster"),  # 529 pixels: 2 strips of 12 and 11 rows
    (23, 24, 7, "cluster"),
    (24, 24, 7, "cluster"),  # the grid-24 cod of tests/test_torch_train.py
    (64, 64, 7, "cluster"),  # the paper's grid-64 ablation: 8 strips of 8 rows, 4096 pixels
    (64, 64, 1, "cluster"), (64, 64, 3, "cluster"), (64, 64, 5, "cluster"),
    (4096, 1, 7, "cluster"),  # 4096 pixels in 8 strips of 512 rows
    (4097, 1, 7, "tiled"),  # 4097 pixels: a ninth block
    (17, 241, 7, "tiled"),  # 4097 pixels again
    (1, 600, 7, "tiled"),  # a row wider than a block
    (1, 4096, 7, "tiled"),
    (65, 64, 7, "tiled"),  # 9 strips
    (90, 90, 7, "tiled"), (96, 96, 7, "tiled"), (128, 128, 7, "tiled"),
    (64, 64, 9, "tiled"),  # k not a template argument of the cluster kernels
    (12, 12, 9, "tiled"), (12, 12, 11, "tiled"),  # the kernel9 and kernel11 ablations at the recipe's grid
    (12, 12, 3, "fused"),  # baseline's k = 3 (cod -o model.diffusion_kernel=3)
    (8, 512, 3, "cluster"),  # strips of one row, r = 1
    (8, 512, 5, "tiled"),  # a strip shorter than r = 2
    (16, 200, 5, "cluster"), (16, 200, 7, "tiled"),  # strips of 2 rows
    (12, 12, 13, "per_step"), (96, 96, 13, "per_step"),  # k beyond the tiled kernels' templates
])
def test_stencil_route(h, w, k, route, dtype):
    assert D.stencil_route(h, w, k, dtype) == route
    assert D.fused_path(h, w, k, dtype) is (route == "fused")


def test_stencil_route_counts_shared_memory_by_dtype():
    """6 x 170 at k = 7 splits into 2 strips of 3 rows; the backward's k²
    weight planes of a strip and its halo rows take 300 KB in fp32, more
    than a block's 227 KB, and 150 KB in bf16."""
    assert D.cluster_split(6, 170) == (2, 3)
    assert D.stencil_route(6, 170, 7, torch.float32) == "tiled"
    assert D.stencil_route(6, 170, 7, torch.bfloat16) == "cluster"


@pytest.mark.parametrize("h,w,split", [
    (64, 64, (8, 8)), (23, 23, (2, 12)), (23, 24, (2, 12)), (24, 30, (2, 12)), (33, 17, (2, 17)),
    (80, 50, (8, 10)), (4096, 1, (8, 512)), (65, 64, (9, 8)), (10, 170, (4, 3)), (12, 12, (1, 12)),
    (1, 513, (0, 0)), (0, 5, (0, 0)),
])
def test_cluster_split(h, w, split):
    """As few strips as hold at most 512 pixels each, as even as that
    allows; every strip but the last full, none empty."""
    assert D.cluster_split(h, w) == split
    blocks, rows = split
    if blocks:
        assert rows * w <= D.FUSED_MAX_PIXELS and 0 < h - (blocks - 1) * rows <= rows


def test_cluster_split_never_leaves_an_empty_strip():
    for w in range(1, 100):
        for h in range(1, 300):
            blocks, rows = D.cluster_split(h, w)
            assert blocks == -(-h // (D.FUSED_MAX_PIXELS // w)) and rows * w <= D.FUSED_MAX_PIXELS
            assert 0 < h - (blocks - 1) * rows <= rows


def test_cpu_above_the_fused_limit_takes_plain_and_counts_no_launch():
    """A 24 x 24 plane (the cluster route on CUDA) on the CPU: the plain
    forward and backward, no kernel counted."""
    x, w = _planes(8, 2, 24, 24, 7)
    g = torch.rand(2, 24, 24, generator=torch.Generator().manual_seed(8))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = _plane_launches()
    out = D.diffusion_planes(xa, wa, 7, 4)
    out.backward(g)
    assert _plane_launches() == before
    ref = D.diffusion_planes_plain(xb, wb, 7, 4)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    ref.backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_limit_is_the_pixel_count(dtype):
    """Within the pixel limit the fused backward's shared memory (three
    padded fp32 planes and the k² weight planes) stays under a block's 227 KB,
    so every plane of at most 512 pixels at k <= 7 is fused."""
    for k in D.FUSED_KERNELS:
        for h in range(1, D.FUSED_MAX_PIXELS + 1):
            w = D.FUSED_MAX_PIXELS // h  # the widest plane of h rows within the limit
            assert D.fused_path(h, w, k, dtype)
            assert not D.fused_path(h, w + 1, k, dtype)


def test_cpu_backward_takes_stacked_step_inputs():
    """The backward takes the step inputs as a list or as the one
    (steps, P, H, W) tensor the forward saves; on the CPU both give the plain
    version's result and count no launch."""
    x, w = _planes(6, 3, 5, 7, 3)
    g = torch.rand(3, 5, 7, generator=torch.Generator().manual_seed(6))
    xs = [x, D.diffusion_step_plain(x, w, 3), D.diffusion_step_plain(D.diffusion_step_plain(x, w, 3), w, 3)]
    before = _plane_launches()
    dx, dw = D.diffusion_planes_bwd(g, torch.stack(xs), w, 3)
    assert _plane_launches() == before
    rdx, rdw = D.diffusion_planes_bwd_plain(g, xs, w, 3)
    torch.testing.assert_close(dx, rdx, rtol=0, atol=0)
    torch.testing.assert_close(dw, rdw, rtol=0, atol=0)


def test_cpu_zero_steps_gradient_is_identity():
    x, w = _planes(7, 2, 4, 5, 3)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = D.diffusion_planes(xa, wa, 3, 0)
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    g = torch.rand(2, 4, 5, generator=torch.Generator().manual_seed(7))
    out.backward(g)
    torch.testing.assert_close(xa.grad, g, rtol=0, atol=0)
    assert not wa.grad.any()


def test_plain_bf16_rounds_every_step():
    x, w = _planes(1, 2, 6, 6, 3)
    xb, wb = x.bfloat16(), w.bfloat16()
    out = D.diffusion_planes_plain(xb, wb, 3, 2)
    ref = D.diffusion_planes_plain(D.diffusion_planes_plain(xb, wb, 3, 1), wb, 3, 1)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_affinity_planes_layout():
    """Regressor channel o = c·k² + t lands at plane c, tap t; taps sum to 1."""
    b, c, k, h, w = 2, 3, 3, 4, 5
    x = torch.randn(b, c, h, w)
    weight = torch.rand(b, c * k * k, h, w)
    xp, wt = affinity_planes(x, weight, k)
    assert xp.shape == (b * c, h, w) and wt.shape == (b * c, k * k, h, w)
    torch.testing.assert_close(xp[1 * c + 2], x[1, 2])
    s = weight[1, 2 * k * k : 3 * k * k]
    torch.testing.assert_close(wt[1 * c + 2], s / (s.sum(0, keepdim=True) + 1e-5))


def test_non_cpu_tensor_requiring_grad_raises():
    """Off the CPU the wrapper never takes a plain version: a tensor that
    requires grad on a device that is neither the CPU nor CUDA is refused."""
    x = torch.empty(2, 5, 5, device="meta", requires_grad=True)
    w = torch.empty(2, 9, 5, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        D.diffusion_planes(x, w, 3, 2)


def test_cpu_requires_grad_takes_plain_backward():
    """On the CPU a tensor that requires grad gets the plain backward: the
    gradients equal autograd through the plain forward, and no kernel is
    counted."""
    x, w = _planes(2, 3, 6, 7, 3)
    g = torch.rand(3, 6, 7, generator=torch.Generator().manual_seed(3))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = _plane_launches()
    D.diffusion_planes(xa, wa, 3, 3).backward(g)
    assert _plane_launches() == before
    D.diffusion_planes_plain(xb, wb, 3, 3).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


def test_plain_backward_chain_sums_dw_in_fp32():
    """The chained plain backward keeps dx in x's dtype per step and rounds
    the summed dw to w's dtype once."""
    x, w = _planes(4, 2, 5, 5, 3)
    xb, wb = x.bfloat16(), w.bfloat16()
    xs = [xb, D.diffusion_step_plain(xb, wb, 3)]
    g = torch.rand(2, 5, 5, generator=torch.Generator().manual_seed(5)).bfloat16()
    dx, dw = D.diffusion_planes_bwd_plain(g, xs, wb, 3)
    assert dx.dtype == dw.dtype == torch.bfloat16
    g1, dw1 = D.diffusion_step_bwd_plain(g, xs[1], wb, 3)
    g0, dw0 = D.diffusion_step_bwd_plain(g1, xs[0], wb, 3)
    torch.testing.assert_close(dx, g0, rtol=0, atol=0)
    torch.testing.assert_close(dw, (dw1 + dw0).bfloat16(), rtol=0, atol=0)


def test_non_cuda_device_raises():
    x = torch.empty(2, 5, 5, device="meta")
    w = torch.empty(2, 9, 5, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        D.diffusion_planes(x, w, 3, 2)


#: the card cases: the cod recipe's 12x12 grid, the test grid 13x20 (both
#: fused); the paper's grid-64 ablation, a plane just above the fused limit,
#: rectangular and ragged strips, and 8 strips of 512 rows, the cluster
#: limit (all cluster); a row wider than a block (tiled)
CARD_GRIDS = [(12, 12), (13, 20), (64, 64), (23, 23), (24, 30), (33, 17), (80, 50), (4096, 1), (1, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("hw", CARD_GRIDS)
def test_cuda_kernel_matches_plain(cuda, k, hw, steps):
    x, w = _planes(k, 192, *hw, k, cuda)
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        before = _plane_launches()
        out = D.diffusion_planes(xd, wd, k, steps)
        torch.cuda.synchronize()
        assert _plane_launches() == _expected_launches(before, D.stencil_route(*hw, k, dt), steps, bwd=False)
        assert out.dtype == dt
        if dt == torch.float32:
            torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, k, steps), **FP32_TOL)
        else:
            torch.testing.assert_close(out.float(), D.diffusion_planes_plain(xd.float(), wd.float(), k, steps),
                                       rtol=0, atol=bf16_atol(steps))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("hw", CARD_GRIDS)
def test_cuda_backward_kernel_matches_plain(cuda, k, hw, steps):
    x, w = _planes(k + 10, 240, *hw, k, cuda)
    g = torch.rand(240, *hw, generator=torch.Generator().manual_seed(k)).to(cuda)
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        xs = [xd]
        for _ in range(steps - 1):
            xs.append(D.diffusion_step_plain(xs[-1], wd, k))
        xs = xs[:steps]
        before = _plane_launches()
        dx, dw = D.diffusion_planes_bwd(gd, xs, wd, k)
        torch.cuda.synchronize()
        assert _plane_launches() == _expected_launches(before, D.stencil_route(*hw, k, dt), steps, bwd=True)
        assert dx.dtype == dw.dtype == dt
        rdx, rdw = D.diffusion_planes_bwd_plain(gd, xs, wd, k)
        torch.testing.assert_close(dx.float(), rdx.float(), **tol)
        torch.testing.assert_close(dw.float(), rdw.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_forward_saves_step_inputs(cuda, dtype):
    """With autograd on, the fused forward writes every step's input: x, then
    each step's result in x's dtype, the very values the fused forward of
    fewer steps returns."""
    x, w = _planes(3, 192, 12, 12, 7, cuda)
    x, w = x.to(dtype), w.to(dtype)
    out, xs = D._forward_steps(x, w, 7, 4, keep=True)
    assert xs.shape == (4, 192, 12, 12) and xs.dtype == dtype
    assert torch.equal(xs[0], x)
    for s in range(1, 4):
        assert torch.equal(xs[s], D.diffusion_planes(x, w, 7, s))
    assert torch.equal(out, D.diffusion_planes(x, w, 7, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(64, 64), (23, 23), (4096, 1)])
def test_cuda_cluster_forward_saves_step_inputs(cuda, hw, dtype):
    """The cluster forward writes every step's input as the fused one does,
    the values its own calls of fewer steps return, each step rounded to x's
    dtype; one cluster launch a call."""
    x, w = _planes(4, 48, *hw, 7, cuda)
    x, w = x.to(dtype), w.to(dtype)
    before = _plane_launches()
    out, xs = D._forward_steps(x, w, 7, 6, keep=True)
    torch.cuda.synchronize()
    assert _plane_launches() == _expected_launches(before, "cluster", 6, bwd=False)
    assert xs.shape == (6, 48, *hw) and xs.dtype == dtype
    assert torch.equal(xs[0], x)
    for s in range(1, 6):
        assert torch.equal(xs[s], D.diffusion_planes(x, w, 7, s))
    assert torch.equal(out, D.diffusion_planes(x, w, 7, 6))


#: planes of the tiled route at every odd k up to 11, at 1, 4 and 6 steps:
#: beyond a cluster's reach (96²), a 1-row plane whose row is wider than a
#: tile, a column of 4097, 17 x 241 and 100 x 75 (not multiples of their
#: tiles), the kernel9 and kernel11 ablations' planes; and of the per-step
#: route: k = 13 (no tiled template) beyond the fused limit, at 4 steps and
#: at 1, and k = 11 at 17 steps on a plane that one tile does not hold,
#: whose halo no tile holds (plane_route)
TILED_GRIDS = [(96, 96), (1, 4096), (4097, 1), (17, 241), (100, 75)]
TILED_CASES = ([(hw, k) for hw in TILED_GRIDS for k in (1, 3, 5, 7, 9, 11)] + [((12, 12), 9), ((12, 12), 11)])
PLANE_CASES = ([(hw, k, steps, "tiled") for hw, k in TILED_CASES for steps in (1, 4, 6)]
               + [((96, 96), 13, 4, "per_step"), ((23, 23), 13, 1, "per_step"), ((171, 171), 11, 17, "per_step")])


@pytest.mark.cuda
@pytest.mark.parametrize("hw,k,steps,route", PLANE_CASES,
                         ids=[f"{h}x{w}k{k}s{s}" for (h, w), k, s, _ in PLANE_CASES])
def test_cuda_tiled_and_per_step_kernels_match_plain(cuda, hw, k, steps, route):
    """The tiled or the per-step forward (its saved step inputs too) and
    backward against the plain versions, fp32 and bf16: one tiled launch a
    call each way, whatever the step count, or steps + steps per-step
    launches."""
    x, w = _planes(30 + k, 24, *hw, k, cuda)
    g = torch.rand(24, *hw, generator=torch.Generator().manual_seed(k + steps)).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        assert D.plane_route(*hw, k, dt, steps) == route
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        before = _plane_launches()
        out, xs = D._forward_steps(xd, wd, k, steps, keep=True)
        dx, dw = D.diffusion_planes_bwd(gd, xs, wd, k)
        torch.cuda.synchronize()
        after = _expected_launches(_expected_launches(before, route, steps, False), route, steps, True)
        assert _plane_launches() == after
        assert out.dtype == xs.dtype == dx.dtype == dw.dtype == dt
        ref = [xd]
        for _ in range(steps):
            ref.append(D.diffusion_step_plain(ref[-1], wd, k))
        rdx, rdw = D.diffusion_planes_bwd_plain(gd, list(xs), wd, k)
        if dt == torch.float32:
            torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, k, steps), **FP32_TOL)
            torch.testing.assert_close(xs, torch.stack(ref[:-1]), **FP32_TOL)
            tol = FP32_TOL
        else:
            fref = D.diffusion_planes_plain(xd.float(), wd.float(), k, steps)
            torch.testing.assert_close(out.float(), fref, rtol=0, atol=bf16_atol(steps))
            torch.testing.assert_close(xs.float(), torch.stack(ref[:-1]).float(), rtol=0, atol=bf16_atol(steps))
            tol = BWD_BF16_TOL
        torch.testing.assert_close(dx.float(), rdx.float(), **tol)
        torch.testing.assert_close(dw.float(), rdw.float(), **tol)


@pytest.mark.cuda
def test_cuda_tiled_plan_is_the_c_entries_plan(cuda):
    """tiled_plan and tiled_smem give the plan and shared memory that
    csrc/stencil_common.cuh gives, forward and backward, each odd k up to
    13, 1 to 17 steps and each dtype, on planes about the tile limits."""
    planes = [(12, 12), (13, 20), (96, 96), (512, 512), (1, 4096), (4097, 1), (17, 241), (100, 75), (300, 7),
              (3, 900), (171, 171)]
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 3, 5, 7, 9, 11, 13):
            for steps in (1, 2, 4, 6, 9, 16, 17):
                for h, w in planes:
                    for bwd in (False, True):
                        plan, smem = D.native_tiled_plan(h, w, k, steps, dtype, bwd)
                        assert plan == D.tiled_plan(h, w, k, steps, dtype, bwd), (h, w, k, steps, dtype, bwd)
                        assert smem == (D.tiled_smem(*plan[:2], h, w, k, steps, dtype.itemsize, bwd, plan[2])
                                        if plan else 0)


#: (h, w, k) planes about the fused and the cluster limits: 512 pixels (1 x
#: 512 has the fused backward's largest shared memory, 144 KB in fp32) and
#: 513; 4096 pixels in 8 strips, in rows of 64 and of 1; 9 strips; 6 x 170,
#: whose cluster backward needs 300 KB in fp32 and 150 KB in bf16; strips
#: of one row at r = 1 and r = 2
LIMIT_PLANES = [(16, 32, 7), (1, 512, 7), (23, 23, 7), (1, 513, 7), (64, 64, 7), (4096, 1, 7), (65, 64, 7),
                (6, 170, 7), (8, 512, 3), (8, 512, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane", LIMIT_PLANES, ids=[f"{h}x{w}k{k}" for h, w, k in LIMIT_PLANES])
def test_cuda_fused_kernels_take_the_planes_the_predicate_admits(cuda, plane, dtype):
    """Each plane's own route (fused or cluster) runs and agrees with the
    plain versions; the C entries of the other all-steps kernels refuse it,
    so the predicate and the kernels state one limit. The per-step kernels
    take what neither admits; they are tested below."""
    *hw, k = plane
    x, w = _planes(5, 24, *hw, k, cuda)
    x, w = x.to(dtype), w.to(dtype)
    g = torch.rand(24, *hw, generator=torch.Generator().manual_seed(5)).to(cuda).to(dtype)
    xs = torch.empty((4, 24, *hw), dtype=dtype, device=cuda)
    out = torch.empty_like(x)
    route = D.stencil_route(*hw, k, dtype)
    entries = {"fused": (D._fused_forward, D._fused_backward), "cluster": (D._cluster_forward, D._cluster_backward),
               "tiled": (D._tiled_forward, D._tiled_backward)}
    for name, (fwd, bwd) in entries.items():
        if name == route:
            continue
        with pytest.raises(RuntimeError, match="cudaError"):
            fwd(x, w, k, 4, xs, out)
        with pytest.raises(RuntimeError, match="cudaError"):
            bwd(g, xs, w, k)
    fwd, bwd = entries[route]
    fwd(x, w, k, 4, xs, out)
    dx, dw = bwd(g, xs, w, k)
    torch.cuda.synchronize()
    ref = D.diffusion_planes_plain(x.float(), w.float(), k, 4)
    rdx, rdw = D.diffusion_planes_bwd_plain(g, xs, w, k)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **FP32_TOL)
        torch.testing.assert_close(dx, rdx, **FP32_TOL)
        torch.testing.assert_close(dw, rdw, **FP32_TOL)
    else:
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=BF16_ATOL)
        torch.testing.assert_close(dx.float(), rdx.float(), **BWD_BF16_TOL)
        torch.testing.assert_close(dw.float(), rdw.float(), **BWD_BF16_TOL)


@pytest.mark.cuda
def test_cuda_route_is_the_c_entries_route(cuda):
    """stencil_route and cluster_split give the route and split that
    csrc/stencil_common.cuh gives, over every plane of up to 70 rows and 70
    columns, rows of up to 600 and columns of up to 4200, each k and dtype."""
    planes = [(h, w) for h in range(1, 71) for w in range(1, 71)]
    planes += [(1, w) for w in range(500, 601)] + [(h, 1) for h in range(4000, 4201, 7)]
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 3, 5, 7, 9, 11, 13):
            for h, w in planes:
                route, split = D.native_route(h, w, k, dtype)
                assert (route, split) == (D.stencil_route(h, w, k, dtype), D.cluster_split(h, w)), (h, w, k, dtype)


@pytest.mark.cuda
def test_cuda_function_gradients_match_autograd_of_plain(cuda):
    """On CUDA a tensor that requires grad goes through both fused kernels,
    one launch each for all 4 steps."""
    x, w = _planes(7, 240, 12, 12, 7, cuda)
    g = torch.rand(240, 12, 12, generator=torch.Generator().manual_seed(8)).to(cuda)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = _plane_launches()
    D.diffusion_planes(xa, wa, 7, 4).backward(g)
    torch.cuda.synchronize()
    assert _plane_launches() == tuple(b + a for b, a in zip(before, (1, 1, 0, 0, 0, 0, 0, 0)))
    D.diffusion_planes_plain(xb, wb, 7, 4).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,launches", [((64, 64), (0, 0, 1, 1, 0, 0, 0, 0)), ((96, 96), (0, 0, 0, 0, 0, 0, 1, 1))])
def test_cuda_function_gradients_above_the_fused_limit(cuda, hw, launches):
    """The paper's grid-64 planes go through both cluster kernels, one
    launch each for all 4 steps; 96 x 96 through the tiled ones."""
    x, w = _planes(9, 48, *hw, 7, cuda)
    g = torch.rand(48, *hw, generator=torch.Generator().manual_seed(9)).to(cuda)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = _plane_launches()
    D.diffusion_planes(xa, wa, 7, 4).backward(g)
    torch.cuda.synchronize()
    assert _plane_launches() == tuple(b + a for b, a in zip(before, launches))
    D.diffusion_planes_plain(xb, wb, 7, 4).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


# the ablations' planes at the recipe's grid and train batch (10 x 24
# latent channels): kernel9 and kernel11 take the tiled kernels (one tile a
# plane), k = 3 at 6 steps the fused ones, k = 13 (beyond the tiled
# kernels' templates) the per-step ones
VARIANT_PLANES = [(9, 4, "tiled"), (11, 4, "tiled"), (3, 6, "fused"), (13, 4, "per_step")]


@pytest.mark.cuda
@pytest.mark.parametrize("k,steps,route", VARIANT_PLANES, ids=[f"k{k}s{s}" for k, s, _ in VARIANT_PLANES])
def test_cuda_model_variant_planes_match_plain(cuda, k, steps, route):
    """Forward and backward through the autograd Function on (240, 12, 12)
    planes, fp32 and bf16, against the plain versions; per call 1 + 1
    launches on the fused and the tiled routes, steps + steps on the
    per-step one."""
    x, w = _planes(20 + k, 240, 12, 12, k, cuda)
    g = torch.rand(240, 12, 12, generator=torch.Generator().manual_seed(k)).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        assert D.stencil_route(12, 12, k, dt) == route
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        xa, wa = xd.clone().requires_grad_(), wd.clone().requires_grad_()
        before = _plane_launches()
        out = D.diffusion_planes(xa, wa, k, steps)
        out.backward(gd)
        torch.cuda.synchronize()
        slot = _SLOTS[route]
        add = [0] * 8
        add[slot] = add[slot + 1] = steps if route == "per_step" else 1
        assert _plane_launches() == tuple(b + a for b, a in zip(before, add))
        ref = D.diffusion_planes_plain(xd.float(), wd.float(), k, steps)
        xs = [xd]
        for _ in range(steps - 1):
            xs.append(D.diffusion_step_plain(xs[-1], wd, k))
        rdx, rdw = D.diffusion_planes_bwd_plain(gd, xs, wd, k)
        if dt == torch.float32:
            torch.testing.assert_close(out.detach(), ref, **FP32_TOL)
            tol = FP32_TOL
        else:
            torch.testing.assert_close(out.detach().float(), ref, rtol=0, atol=bf16_atol(steps))
            tol = BWD_BF16_TOL
        torch.testing.assert_close(xa.grad.float(), rdx.float(), **tol)
        torch.testing.assert_close(wa.grad.float(), rdw.float(), **tol)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs(cuda):
    x, w = _planes(0, 2, 5, 5, 3, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        D.diffusion_planes(x.clone().requires_grad_(), w.cpu(), 3, 2)
    with pytest.raises(TypeError):
        D.diffusion_planes(x.half(), w.half(), 3, 2)
    with pytest.raises(ValueError):
        D.diffusion_planes(x, w[:, :4], 3, 2)
    with pytest.raises(ValueError):
        D.diffusion_planes(x.transpose(1, 2), w, 3, 2)


# ---------------------------------------------------------------------------
# NHWC stencil on tap-major weights
# ---------------------------------------------------------------------------


def _nhwc(seed, b, h, w, c, k, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, h, w, c, generator=g)
    raw = torch.rand(b, h, w, c, k * k, generator=g)
    return x.to(device), (raw / (raw.sum(-1, keepdim=True) + 1e-5)).to(device)


def test_nhwc_plain_matches_plane_plain():
    """The NHWC plain step is the plane plain step on transposed tensors."""
    b, h, w, c, k = 2, 6, 7, 3, 3
    x, nw = _nhwc(0, b, h, w, c, k)
    out = D.diffusion_nhwc_plain(x, D.to_tap_major(nw), k, 2)
    xp = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
    wp = nw.permute(0, 3, 4, 1, 2).reshape(b * c, k * k, h, w)
    ref = D.diffusion_planes_plain(xp, wp, k, 2).view(b, c, h, w).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, ref, **FP32_TOL)


def _nhwc_launches():
    """the NHWC plane, grid and per-step kernels' counters"""
    return D.NHWC_PLANE_LAUNCHES, D.NHWC_GRID_LAUNCHES, D.NHWC_LAUNCHES


def test_nhwc_cpu_takes_plain_and_counts_no_launch():
    x, nw = _nhwc(1, 2, 5, 6, 4, 3)
    before = (*_nhwc_launches(), *_plane_launches())
    xa, wa = x.clone().requires_grad_(), nw.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), nw.clone().requires_grad_()
    out = D.diffusion_nhwc(xa, wa, 3, 3)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g)
    assert (*_nhwc_launches(), *_plane_launches()) == before
    ref = D.diffusion_nhwc_plain(xb, D.to_tap_major(wb), 3, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    ref.backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [0, 1, 4])
def test_nhwc_cpu_forward_saves_the_plain_chains_step_inputs(dtype, steps):
    x, nw = _nhwc(4, 2, 7, 9, 5, 3)
    x, wt = x.to(dtype), D.to_tap_major(nw).to(dtype)
    before = _nhwc_launches()
    out, xs = D._nhwc_forward_steps(x, wt, 3, steps, keep=True)
    assert _nhwc_launches() == before
    assert xs.shape == (steps, *x.shape) and xs.dtype == dtype and out is not x
    chain = [x]
    for _ in range(steps):
        chain.append(D.diffusion_step_nhwc_plain(chain[-1], wt, 3))
    for s in range(steps):
        torch.testing.assert_close(xs[s], chain[s], rtol=0, atol=0)
    torch.testing.assert_close(out, chain[-1], rtol=0, atol=0)
    assert D._nhwc_forward_steps(x, wt, 3, steps, keep=False)[1] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,k,route", [
    ((12, 12), 7, "plane"), ((12, 12), 1, "plane"), ((12, 12), 9, "plane"), ((12, 12), 11, "grid"),
    ((96, 96), 7, "grid"), ((512, 512), 7, "grid"), ((64, 64), 3, "grid"), ((23, 23), 1, "plane"),
    ((12, 12), 13, "per_step"), ((96, 96), 13, "per_step"), ((1, 1), 15, "per_step"),
])
def test_nhwc_route(hw, k, route, dtype):
    """The NHWC kernels' route from shape and dtype alone: the recipe's
    12x12 is one plane-kernel block with its w on chip; 96² and 512² take
    the grid kernel; k = 13 the per-step kernel."""
    assert D.nhwc_route(*hw, k, dtype) == route
    if route == "plane":
        assert D.nhwc_plane_smem(*hw, k, dtype) <= D.FUSED_SMEM_LIMIT


def test_nhwc_plane_smem_counts_the_group_and_the_padded_plane():
    # 12x12 at k = 7: two fp32 buffers of 18x18 pixels and 49 taps of w a
    # pixel, for 8 bf16 (16 bytes) or 4 fp32 channels
    assert D.nhwc_plane_smem(12, 12, 7, torch.bfloat16) == 2 * 4 * 18 * 18 * 8 + 144 * 49 * 16
    assert D.nhwc_plane_smem(12, 12, 7, torch.float32) == 2 * 4 * 18 * 18 * 4 + 144 * 49 * 16


def test_nhwc_route_depends_on_dtype():
    # a 13x20 plane's w at k = 7 fits beside the buffers in fp32 (4
    # channels a block) but not in bf16 (8 channels)
    assert D.nhwc_route(13, 20, 7, torch.float32) == "plane"
    assert D.nhwc_route(13, 20, 7, torch.bfloat16) == "grid"


def test_nhwc_gradcheck_float64():
    g = torch.Generator().manual_seed(3)
    x = torch.rand(1, 4, 5, 2, generator=g, dtype=torch.float64, requires_grad=True)
    raw = torch.rand(1, 4, 5, 2, 9, generator=g, dtype=torch.float64)
    nw = (raw / raw.sum(-1, keepdim=True)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: D.diffusion_nhwc(a, b, 3, 2), (x, nw))


def test_nhwc_non_cuda_device_raises():
    x = torch.empty(1, 5, 5, 2, device="meta")
    w = torch.empty(1, 5, 5, 18, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        D.diffusion_nhwc_tap_major(x, w, 3, 2)


def _nhwc_expected(before, h, w, k, dtype, steps):
    """The NHWC counters after one call: one plane or grid launch for all
    the steps, or one per-step launch a step."""
    slot = {"plane": 0, "grid": 1, "per_step": 2}[D.nhwc_route(h, w, k, dtype)]
    add = [0, 0, 0]
    add[slot] = steps if slot == 2 else int(steps > 0)
    return tuple(b + a for b, a in zip(before, add))


NHWC_GRIDS = [(12, 12), (13, 20), (23, 23), (64, 64), (96, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 5, 24, 64])
@pytest.mark.parametrize("steps", [0, 1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 13])
@pytest.mark.parametrize("hw", NHWC_GRIDS)
def test_cuda_nhwc_kernel_matches_plain(cuda, k, hw, steps, c):
    """Every grid, k, step count and channel count (C = 1 and 5 leave the
    channel group a masked tail and take the element route) in fp32 and
    bf16, with the launches of the route the shape names."""
    x, nw = _nhwc(k * 100 + c, 2, *hw, c, k, cuda)
    wt = D.to_tap_major(nw)
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), wt.to(dt)
        before = _nhwc_launches()
        out = D.diffusion_nhwc_tap_major(xd, wd, k, steps)
        torch.cuda.synchronize()
        assert _nhwc_launches() == _nhwc_expected(before, *hw, k, dt, steps)
        assert out.dtype == dt and out.shape == x.shape
        ref = D.diffusion_nhwc_plain(xd.float(), wd.float(), k, steps)
        tol = FP32_TOL if dt == torch.float32 else dict(rtol=0, atol=bf16_atol(steps))
        torch.testing.assert_close(out.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,k", [((12, 12), 7), ((96, 96), 7), ((23, 23), 13)])
def test_cuda_nhwc_forward_saves_step_inputs(cuda, hw, k, dtype):
    """Each route (plane, grid, per-step) writes the chain's step inputs."""
    x, nw = _nhwc(11, 2, *hw, 24, k, cuda)
    x, wt = x.to(dtype), D.to_tap_major(nw).to(dtype)
    out, xs = D._nhwc_forward_steps(x, wt, k, 4, keep=True)
    torch.cuda.synchronize()
    assert xs.shape == (4, *x.shape) and torch.equal(xs[0], x)
    tol = FP32_TOL if dtype == torch.float32 else dict(rtol=0, atol=bf16_atol(4))
    for s in range(1, 4):
        torch.testing.assert_close(xs[s].float(), D.diffusion_nhwc_plain(x.float(), wt.float(), k, s), **tol)
    out2, none = D._nhwc_forward_steps(x, wt, k, 4, keep=False)
    assert none is None and torch.equal(out, out2)


@pytest.mark.cuda
def test_cuda_nhwc_route_is_the_c_entries_route(cuda):
    for dt in (torch.float32, torch.bfloat16):
        for hw in NHWC_GRIDS + [(512, 512), (1, 700), (300, 2), (40, 33), (12, 30)]:
            for k in (1, 3, 5, 7, 9, 11, 13):
                route, smem = D.native_nhwc_route(*hw, k, dt)
                assert route == D.nhwc_route(*hw, k, dt), (hw, k, dt)
                if route != "per_step":
                    assert smem == D.nhwc_plane_smem(*hw, k, dt)


@pytest.mark.cuda
def test_cuda_nhwc_entries_refuse_planes_of_another_route(cuda):
    x, nw = _nhwc(12, 1, 96, 96, 8, 7, cuda)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        D._nhwc_plane_forward(x, D.to_tap_major(nw), 7, 4, None, torch.empty_like(x))
    x, nw = _nhwc(13, 1, 12, 12, 8, 13, cuda)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        D._nhwc_grid_forward(x, D.to_tap_major(nw), 13, 4, None, torch.empty_like(x))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(12, 12), (96, 96)])
def test_cuda_nhwc_gradients_go_through_both_kernels(cuda, hw):
    x, nw = _nhwc(5, 2 if hw == (96, 96) else 8, *hw, 24, 7, cuda)
    g = torch.rand(x.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    xa, wa = x.clone().requires_grad_(), nw.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), nw.clone().requires_grad_()
    before = (*_nhwc_launches(), *_plane_launches())
    D.diffusion_nhwc(xa, wa, 7, 4).backward(g)
    torch.cuda.synchronize()
    # one NHWC launch forward (the plane kernel at 12x12, the grid kernel at
    # 96x96); the planes take the plane backward of their route (fused at
    # 12x12, tiled at 96x96), one launch
    route = D.plane_route(*hw, 7, torch.float32, 4)
    assert route == ("fused" if hw == (12, 12) else "tiled")
    assert (*_nhwc_launches(), *_plane_launches()) == (
        *_nhwc_expected(before[:3], *hw, 7, torch.float32, 4), *_expected_launches(before[3:], route, 4, bwd=True))
    D.diffusion_nhwc_plain(xb, D.to_tap_major(wb), 7, 4).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

# fp32 kernel vs plain: the same two-pass fp32 arithmetic summed in another
# order, held to tests/test_layernorm_pallas.py's rtol 1e-4 / atol 1e-5; on
# mean-100 rows the mean itself differs by a few ulps of 100 (7.6e-6 each)
# between the two orders, times rstd·|scale| (~1/3 · 4): atol 1e-4. bf16:
# both round nearly the same fp32 value once, so one ulp at most
LN_FP32_TOL = {0.0: dict(rtol=1e-4, atol=1e-5), 100.0: dict(rtol=1e-4, atol=1e-4)}
LN_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _ln_inputs(seed, rows, c, mean=0.0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=g) * 3 + mean
    return x.to(device), torch.randn(c, generator=g).to(device), torch.randn(c, generator=g).to(device)


def test_layer_norm_cpu_takes_plain_and_counts_no_launch():
    x, s, b = _ln_inputs(0, 10, 37)
    before = L.LAUNCHES
    out = L.layer_norm(x, s, b, 1e-6)
    assert L.LAUNCHES == before
    torch.testing.assert_close(out, L.layer_norm_plain(x, s, b, 1e-6), rtol=0, atol=0)
    torch.testing.assert_close(out, torch.nn.functional.layer_norm(x, (37,), s, b, 1e-6), rtol=1e-5, atol=1e-5)


def test_layer_norm_gradients_are_autograd_of_plain():
    x, s, b = _ln_inputs(1, 6, 20)
    ins = [t.clone().requires_grad_() for t in (x, s, b)]
    refs = [t.clone().requires_grad_() for t in (x, s, b)]
    (L.layer_norm(*ins) ** 2).sum().backward()
    (L.layer_norm_plain(*refs) ** 2).sum().backward()
    for a, r in zip(ins, refs):
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=0)


def test_layer_norm_non_cuda_device_raises():
    with pytest.raises(ValueError, match="CUDA"):
        L.layer_norm(torch.empty(4, 8, device="meta"), torch.empty(8, device="meta"), torch.empty(8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 31, 64, 130, 1024, 1025, 2048, 4096])
def test_cuda_layer_norm_matches_plain(cuda, c):
    for mean in (0.0, 100.0):
        x, s, b = _ln_inputs(c, 300, c, mean, cuda)
        before = L.LAUNCHES
        out = L.layer_norm(x, s, b, 1e-5)
        torch.cuda.synchronize()
        assert L.LAUNCHES == before + 1
        torch.testing.assert_close(out, L.layer_norm_plain(x, s, b, 1e-5), **LN_FP32_TOL[mean])
        xb = x.bfloat16()
        outb = L.layer_norm(xb, s, b, 1e-5)
        assert outb.dtype == torch.bfloat16
        torch.testing.assert_close(outb.float(), L.layer_norm_plain(xb, s, b, 1e-5).float(), **LN_BF16_TOL)


# the LayerNorm widths chip_smoke.py's phase 13 drives: the lane-group
# route's lane counts 1..32 and 1, 2, 4, 8 vectors a lane, C = 130 (a row
# not a multiple of 16 bytes: the scalar route) and C = 2048 (the block route)
LN_ROUTE_CS = (8, 24, 64, 128, 256, 512, 1024, 130, 2048)
LN_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _ln_expected_route(c, aligned):
    if c > L.WARP_MAX_C:
        return "block"
    return "group" if aligned and c != 130 else "scalar"


@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("c", LN_ROUTE_CS)
def test_layer_norm_route_chooser(c, dtype):
    """The route for each (C, dtype, alignment) of phase 13: a view one
    element off a 16-byte boundary (x[1:] of a flat buffer) leaves the
    lane-group route for the scalar one."""
    dt = LN_DTYPES[dtype]
    esize = torch.finfo(dt).bits // 8
    assert L.ln_route(c, dt, 4096, 8192) == _ln_expected_route(c, True)
    assert L.ln_route(c, dt, 4096 + esize, 8192) == _ln_expected_route(c, False)
    assert L.ln_route(c, dt, 4096, 8192 + esize) == _ln_expected_route(c, False)


def test_layer_norm_group_shape():
    """G lanes a row (its 16-byte vectors rounded up to a power of two) and
    the vectors a lane holds: C = 64 bf16 is 8 lanes (4 rows a warp); 24
    bf16 is 3 vectors on 4 lanes, 24 fp32 6 on 8; past 32 vectors a lane
    holds several."""
    bf, f32 = torch.bfloat16, torch.float32
    assert L.ln_group_shape(64, bf) == (8, 1) and L.ln_group_shape(64, f32) == (16, 1)
    assert L.ln_group_shape(128, bf) == (16, 1) and L.ln_group_shape(256, bf) == (32, 1)
    assert L.ln_group_shape(24, bf) == (4, 1) and L.ln_group_shape(24, f32) == (8, 1)
    assert L.ln_group_shape(8, bf) == (1, 1) and L.ln_group_shape(8, f32) == (2, 1)
    assert L.ln_group_shape(512, bf) == (32, 2) and L.ln_group_shape(1024, bf) == (32, 4)
    assert L.ln_group_shape(1024, f32) == (32, 8)


def _ln_misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("c", LN_ROUTE_CS)
def test_cuda_layer_norm_routes_match_plain(cuda, c, dtype, aligned):
    """Each route against the plain version at phase 13's widths, on a row
    count that no block or warp divides, mean-0 and mean-100 rows; the
    kernel reports the route ln_route predicts."""
    dt = LN_DTYPES[dtype]
    for mean in (0.0, 100.0):
        x, s, b = _ln_inputs(c + int(mean), 1001, c, mean, cuda)
        x = x.to(dt) if aligned else _ln_misaligned(x.to(dt))
        out = torch.empty_like(x)
        route = L.ln_route(c, dt, x.data_ptr(), out.data_ptr())
        assert route == _ln_expected_route(c, aligned)
        assert L.kernel_route(c, dt, x.data_ptr(), out.data_ptr()) == route
        before = L.LAUNCHES
        L.launch(x, s, b, out, 1e-5)
        torch.cuda.synchronize()
        assert L.LAUNCHES == before + 1
        tol = LN_FP32_TOL[mean] if dt == torch.float32 else LN_BF16_TOL
        torch.testing.assert_close(out.float(), L.layer_norm_plain(x, s, b, 1e-5).float(), **tol)


@pytest.mark.cuda
def test_cuda_layer_norm_refuses_bad_inputs(cuda):
    x, s, b = _ln_inputs(0, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        L.layer_norm(x.half(), s, b)
    with pytest.raises(ValueError):
        L.layer_norm(x, s[:8], b)
    with pytest.raises(ValueError):
        L.layer_norm(x.t(), s[:8], b[:8])
    with pytest.raises(ValueError, match="CUDA"):
        L.layer_norm(x, s.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 24, 24), (2, 37, 23), (2, 384, 384), (1, 704, 704)])
def test_cuda_batch_statistics_match_cpu(cuda, shape):
    """The val statistics on the card equal the CPU's: histograms and counts
    exactly, MAE and S-measure (float64, summed in another order) to
    tests/test_metrics.py's S-measure bar."""
    b, h, w = shape
    g = torch.Generator().manual_seed(h)
    prob = torch.rand(b, h, w, 1, generator=g) * 0.6 + 0.2
    label = torch.zeros(b, h, w, 1)
    label[:, h // 5 : h // 2, w // 4 : w - 3] = 1.0
    label[-1, : h // 3] = 0.0
    cpu = statistics_to_host(batch_statistics(prob, label))
    with torch.inference_mode():  # as cod.predict hands its output over
        prob_dev = prob.to(cuda)
    dev = batch_statistics(prob_dev, label.to(cuda))
    assert all(v.device.type == "cuda" for v in dev.values())
    dev = statistics_to_host(dev)
    for k in ("fg_hist", "bg_hist", "gt_count", "n_pixels"):
        np.testing.assert_array_equal(dev[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(dev["mae_sum"], cpu["mae_sum"], rtol=1e-10)
    np.testing.assert_allclose(dev["sm"], cpu["sm"], rtol=1e-4, atol=1e-5)
