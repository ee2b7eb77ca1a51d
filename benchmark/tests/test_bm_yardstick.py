"""The yardstick's counts on the CPU: the configurations' FLOPs recounted
at their shapes, the stencil bounds held to ``chip_smoke.py``'s at the
kernel table's shapes, and the trace reduction on a hand-made trace."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import yardstick
from benchmark.tests.conftest import BENCH, REPO
from benchmark.yardstick import DeviceOp, HostOp, Trace


@pytest.mark.parametrize("name", ["cod-pvtb2-384", "dqnet-pvtb2-384"])
def test_flops_recount(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    for size, stored in cfg["flops_per_image"].items():
        if size.isdigit():
            assert yardstick.count_flops(cfg["architecture"], int(size)) == stored


def test_depthwise_backward_counts_groups():
    """grad-input and grad-weight each cost the forward's FLOPs, groups
    included (PyTorch's own formula counts a depthwise grad-weight C times)."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(2, 16, 8, 8, requires_grad=True)
    w = torch.randn(16, 1, 3, 3, requires_grad=True)
    mapping = {torch.ops.aten.convolution_backward: yardstick._conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        torch.nn.functional.conv2d(x, w, padding=1, groups=16).sum().backward()
    fwd = 2 * 2 * 64 * 16 * 1 * 9
    assert fc.get_total_flops() == 3 * fwd


@pytest.mark.parametrize("p,h,w,k,steps", [(192, 12, 12, 7, 4), (240, 12, 12, 7, 4), (480, 12, 12, 7, 4),
                                           (192, 64, 64, 7, 4), (1536, 12, 12, 7, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stencil_bounds_match_chip_smoke(p, h, w, k, steps, dtype):
    import sys

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    x = torch.empty(p, h, w, dtype=dtype)
    wt = torch.empty(p, k * k, h, w, dtype=dtype)
    elem = x.element_size()
    assert yardstick.stencil_bound(p, h, w, k, steps, elem) == chip_smoke.stencil_bound(x, wt, k, steps)
    xs = [x] * steps
    assert yardstick.stencil_bwd_bound(p, h, w, k, steps, elem) == chip_smoke.stencil_bwd_bound(x, xs, wt, k)


def test_kernel_table_bounds():
    """The table's rows 1 and 2: 0.000842 and 0.002146 ms in bf16."""
    assert yardstick.stencil_bound(192, 12, 12, 7, 4, 2)[0] == pytest.approx(0.000842, abs=5e-7)
    assert yardstick.stencil_bwd_bound(240, 12, 12, 7, 4, 2)[0] == pytest.approx(0.002146, abs=5e-7)


def _trace():
    dev = [DeviceOp("gemm_a", 0.0, 10.0, 1), DeviceOp("gemm_b", 5.0, 12.0, 2),  # overlap: busy 0..12
           DeviceOp("stencil_fused_fwd_kernel", 20.0, 22.0, 3), DeviceOp("stencil_fused_bwd_kernel", 30.0, 34.0, 4),
           DeviceOp("conv", 40.0, 50.0, 5)]
    host = [HostOp("aten::mm", 0.0, 4.0, 1, 0), HostOp("cudaLaunchKernel", 1.0, 2.0, 1, 1),
            HostOp("cudaLaunchKernel", 3.0, 3.5, 1, 2), HostOp("bench.prompt_encoder", 14.0, 19.0, 1, 0),
            HostOp("cudaLaunchKernel", 15.0, 16.0, 1, 3), HostOp("aten::conv2d", 12.5, 19.5, 1, 0),
            HostOp("python_step", 0.0, 60.0, 1, 0), HostOp("cudaLaunchKernel", 25.0, 26.0, 1, 4),
            HostOp("cudaLaunchKernel", 35.0, 36.0, 1, 5)]
    return Trace(dev, host, 60e-6, 2)


def test_trace_union_and_breakdown():
    t = _trace()
    assert t.busy_intervals() == [(0.0, 12.0), (20.0, 22.0), (30.0, 34.0), (40.0, 50.0)]
    assert t.busy_s() == pytest.approx(28e-6)
    assert t.kernel_seconds(lambda n: yardstick.stencil_kernels(n, "fwd")) == (pytest.approx(2e-6), 1)
    assert t.kernel_seconds(lambda n: yardstick.stencil_kernels(n, "bwd")) == (pytest.approx(4e-6), 1)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["gemm_a", pytest.approx(10e-6)]
    idle = dict((n, s) for n, s in bd["idle_gaps"])
    # the gap 12..20 has its middle (16) in aten::conv2d and, inside it,
    # the range; 22..30 and 34..40 only in python_step
    assert idle == {"bench.prompt_encoder": pytest.approx(8e-6), "python_step": pytest.approx(14e-6)}


def test_trace_range_by_correlation_and_by_span():
    t = _trace()
    assert t.range_device_s("bench.prompt_encoder") == pytest.approx(2e-6)
    assert t.range_device_s("absent") is None
    spanned = Trace(t.device_ops, t.host_ops, t.window_s, 2,
                    annotations=[DeviceOp("bench.prompt_encoder", 19.0, 35.0, 0)])
    assert spanned.range_device_s("bench.prompt_encoder") == pytest.approx(6e-6)


def test_kernel_categories():
    t = _trace()
    assert yardstick.kernel_category("void cutlass::Kernel2<sm90_xmma_gemm>") == "gemm/matmul"
    assert yardstick.kernel_category("stencil_fused_bwd_kernel<7>") == "diffusion stencil backward (ours)"
    assert t.by_category()["diffusion stencil (ours)"] == pytest.approx(2e-6)
