"""The port's CUDA stencil wrappers: dispatch, refusals, and (on a card) the
forward and backward kernels against their plain versions.

This file imports neither JAX nor ``dgtd_tpu``, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py``
(the ``cuda``-marked tests skip without a card).
"""

import numpy as np
import pytest
import torch

from dgtd_tpu_torch.models.diffusion import affinity_planes
from dgtd_tpu_torch.ops import diffusion as D

# fp32: the kernel's FMA chain vs unfold·w·sum, a few ulps of O(1) values
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16: the kernel rounds to bf16 after each of 4 steps; inputs in [0, 1)
# and convex weights keep each rounding under 2^-9
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


def _planes(seed, p, h, w, k, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(p, h, w, generator=g)
    raw = torch.rand(p, k * k, h, w, generator=g)
    return x.to(device), (raw / (raw.sum(1, keepdim=True) + 1e-5)).to(device)


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    x, w = _planes(0, 2, 5, 6, 3)
    before = D.LAUNCHES
    out = D.diffusion_planes(x, w, 3, 2)
    assert D.LAUNCHES == before
    torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, 3, 2), rtol=0, atol=0)


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
    before = (D.LAUNCHES, D.BWD_LAUNCHES)
    D.diffusion_planes(xa, wa, 3, 3).backward(g)
    assert (D.LAUNCHES, D.BWD_LAUNCHES) == before
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("hw", [(12, 12), (13, 20), (64, 64)])
def test_cuda_kernel_matches_plain(cuda, k, hw):
    x, w = _planes(k, 192, *hw, k, cuda)
    before = D.LAUNCHES
    out = D.diffusion_planes(x, w, k, 4)
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 4
    torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, k, 4), **FP32_TOL)
    xb, wb = x.bfloat16(), w.bfloat16()
    outb = D.diffusion_planes(xb, wb, k, 4)
    assert outb.dtype == torch.bfloat16
    torch.testing.assert_close(outb.float(), D.diffusion_planes_plain(xb.float(), wb.float(), k, 4),
                               rtol=0, atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("hw", [(12, 12), (13, 20), (64, 64)])
def test_cuda_backward_kernel_matches_plain(cuda, k, hw):
    x, w = _planes(k + 10, 240, *hw, k, cuda)
    g = torch.rand(240, *hw, generator=torch.Generator().manual_seed(k)).to(cuda)
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        xs = [xd]
        for _ in range(3):
            xs.append(D.diffusion_step_plain(xs[-1], wd, k))
        before = D.BWD_LAUNCHES
        dx, dw = D.diffusion_planes_bwd(gd, xs, wd, k)
        torch.cuda.synchronize()
        assert D.BWD_LAUNCHES == before + 4
        assert dx.dtype == dw.dtype == dt
        rdx, rdw = D.diffusion_planes_bwd_plain(gd, xs, wd, k)
        torch.testing.assert_close(dx.float(), rdx.float(), **tol)
        torch.testing.assert_close(dw.float(), rdw.float(), **tol)


@pytest.mark.cuda
def test_cuda_function_gradients_match_autograd_of_plain(cuda):
    """On CUDA a tensor that requires grad goes through both kernels."""
    x, w = _planes(7, 240, 12, 12, 7, cuda)
    g = torch.rand(240, 12, 12, generator=torch.Generator().manual_seed(8)).to(cuda)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (D.LAUNCHES, D.BWD_LAUNCHES)
    D.diffusion_planes(xa, wa, 7, 4).backward(g)
    torch.cuda.synchronize()
    assert (D.LAUNCHES, D.BWD_LAUNCHES) == (before[0] + 4, before[1] + 4)
    D.diffusion_planes_plain(xb, wb, 7, 4).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **FP32_TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **FP32_TOL)


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
