"""The yardstick: the card's published peaks, the least time of a stencil
call from its shapes, the FLOPs of a model from the reference, and the
reduction of a profiler trace to busy time, idle gaps and a breakdown.

Kept with the benchmark so that later changes to the program cannot move
it. The stencil bounds are copies of ``chip_smoke.py``'s ``stencil_bound``
and ``stencil_bwd_bound`` taking shapes in place of tensors.
"""

from __future__ import annotations

import bisect
import heapq
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
#: HBM3 bandwidth; at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------------------
# stencil bounds (ms): bytes read and written once over HBM, against
# operations over the fp32 rate (the kernels compute in fp32 on CUDA cores)
# ---------------------------------------------------------------------------


def stencil_bound(p: int, h: int, w: int, kernel: int, steps: int, elem_bytes: int) -> Tuple[float, str]:
    """``steps`` forward steps on x (P, H, W) and w (P, k², H, W): x and w
    read once, the output written once; 2 flops per weight per step."""
    wn = p * kernel * kernel * h * w
    nbytes = (2 * p * h * w + wn) * elem_bytes
    flops = 2.0 * wn * steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def stencil_bwd_bound(p: int, h: int, w: int, kernel: int, steps: int, elem_bytes: int) -> Tuple[float, str]:
    """The backward of ``steps`` steps: g, the step inputs and w read once,
    dx and dw written once; 2 flops per in-plane tap for dx, 1 for dw's
    product, and the k²·H·W adds per plane of each cross-step sum."""
    r = kernel // 2
    taps = sum(max(h - abs(d - r), 0) for d in range(kernel)) * sum(max(w - abs(d - r), 0) for d in range(kernel))
    g_numel, w_numel = p * h * w, p * kernel * kernel * h * w
    nbytes = ((2 + steps) * g_numel + 2 * w_numel) * elem_bytes
    flops = p * (3.0 * taps * steps + (steps - 1) * kernel * kernel * h * w)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# FLOPs of a model, counted on the reference
# ---------------------------------------------------------------------------


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                         _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """Each of grad-input and grad-weight costs what the forward did:
    2 · batch · output pixels · C_out · C_in/groups · k². (PyTorch's own
    formula leaves the groups out of grad-weight, which counts a depthwise
    conv's C times over.)"""
    if transposed:
        raise NotImplementedError("no transposed convolution in the benchmarked models")
    n = 1
    for d in grad_out_shape[2:]:
        n *= d
    k = 1
    for d in w_shape[2:]:
        k *= d
    fwd = 2 * grad_out_shape[0] * n * w_shape[0] * w_shape[1] * k
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(arch: dict, size: int, batch: int = 2) -> Dict[str, int]:
    """FLOPs an image of the reference model at ``size``², counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors over
    ``batch`` images: ``forward`` (eval) and ``train`` (train-mode forward,
    loss and backward to the parameters; no recompute). Counted: matrix
    products and convolutions, forward and backward. Not counted: the FFT,
    the stencil's products (elementwise), norms, softmax, pointwise ops."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.losses import model_loss
    from .reference.models import forward, spec

    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    P = {}
    for name, shape, kind, _ in spec(arch):
        t = torch.empty(shape, device="meta", dtype=torch.long if kind == "count" else torch.float32)
        if kind not in ("count", "running_mean", "running_var"):
            t.requires_grad_(True)
        P[name] = t
    image = torch.empty(batch, 3, size, size, device="meta")
    depth = torch.empty(batch, 1, size, size, device="meta")
    label = torch.empty(batch, 1, size, size, device="meta")
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        with torch.no_grad():
            forward(arch, P, image, depth)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        out = forward(arch, P, image, depth, train=True)
        model_loss(arch, out, image, label)[0].backward()
    return {"forward": fwd // batch, "train": fc.get_total_flops() // batch}


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------


class DeviceOp(NamedTuple):
    """One operation on the device: kernel, copy or set (microseconds, the
    trace's clock), and the correlation id of the host call that launched
    it."""
    name: str
    start: float
    end: float
    corr: int


class HostOp(NamedTuple):
    """One host event: an operator, a runtime call or an annotated range
    (microseconds), its thread, and its correlation id (runtime calls)."""
    name: str
    start: float
    end: float
    thread: int
    corr: int


class Trace:
    """A profiler window reduced to what the metrics read: the device's
    operations and the host's events, on one clock."""

    def __init__(self, device_ops: Sequence[DeviceOp], host_ops: Sequence[HostOp], window_s: float, units: int,
                 annotations: Sequence[DeviceOp] = ()):
        self.device_ops = sorted(device_ops, key=lambda o: o.start)
        self.host_ops = list(host_ops)
        #: the device-side spans of annotated ranges
        self.annotations = list(annotations)
        self.window_s = window_s
        #: steps or batches in the window
        self.units = units

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals (overlapping
        operations counted once)."""
        out: List[List[float]] = []
        for op in self.device_ops:
            if out and op.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], op.end)
            else:
                out.append([op.start, op.end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """(summed seconds, count) of the device operations whose name
        ``match`` accepts."""
        ops = [o for o in self.device_ops if match(o.name)]
        return sum(o.end - o.start for o in ops) * 1e-6, len(ops)

    def range_device_s(self, label: str) -> Optional[float]:
        """Device seconds of the operations of the ranges named ``label``,
        their intervals united: those inside the ranges' device-side spans
        where the trace has them, else those launched inside the host
        ranges (on the range's thread, by correlation id); None when the
        trace has no such range."""
        spans = [a for a in self.annotations if a.name == label]
        if spans:
            inside = [o for o in self.device_ops if any(a.start <= o.start and o.end <= a.end for a in spans)]
            return Trace(inside, [], self.window_s, self.units).busy_s()
        ranges = [h for h in self.host_ops if h.name == label]
        if not ranges:
            return None
        launches = sorted((h.start, h.thread, h.corr) for h in self.host_ops if h.corr > 0 and _is_launch(h.name))
        starts = [x[0] for x in launches]
        corrs = set()
        for r in ranges:
            i = bisect.bisect_left(starts, r.start)
            while i < len(launches) and launches[i][0] <= r.end:
                if launches[i][1] == r.thread:
                    corrs.add(launches[i][2])
                i += 1
        sub = Trace([o for o in self.device_ops if o.corr in corrs], [], self.window_s, self.units)
        return sub.busy_s()

    def by_category(self) -> Dict[str, float]:
        """Device seconds summed by kernel category (``kernel_category``)."""
        out: Counter = Counter()
        for o in self.device_ops:
            out[kernel_category(o.name)] += (o.end - o.start) * 1e-6
        return dict(out.most_common())

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (seconds summed by
        name) and the idle gaps summed by the innermost host operation that
        covers each gap's middle (what the host was doing while the device
        waited)."""
        by_name: Counter = Counter()
        for o in self.device_ops:
            by_name[o.name] += (o.end - o.start) * 1e-6
        busy = self.busy_intervals()
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
        hosts = sorted((h for h in self.host_ops if not _is_runtime(h.name)), key=lambda h: h.start)
        idle: Dict[str, float] = defaultdict(float)
        heap: list = []
        j = 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while j < len(hosts) and hosts[j].start <= mid:
                heapq.heappush(heap, (-hosts[j].start, j))
                j += 1
            while heap and hosts[heap[0][1]].end < mid:
                heapq.heappop(heap)
            name = hosts[heap[0][1]].name if heap else "(no host op)"
            idle[name] += (b - a) * 1e-6
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def _is_launch(name: str) -> bool:
    return "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset"))


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def from_profiler(prof, window_s: float, units: int) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``: its
    device operations (kernels, copies, sets; not the annotations' device
    spans) and its host events."""
    import torch

    dev_ops, host_ops, notes = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            op = DeviceOp(e.name, float(tr.start), float(tr.end), int(e.id))
            (notes if getattr(e, "is_user_annotation", False) else dev_ops).append(op)
        else:
            host_ops.append(HostOp(e.name, float(tr.start), float(tr.end), int(e.thread), int(e.id)))
    return Trace(dev_ops, host_ops, window_s, units, notes)


#: kernel categories by a piece of the kernel's name, first match wins
#: (copied from ``dgtd_tpu_torch/tools/profile_step.py::_category``)
CATEGORIES = (
    ("stencil_fused_fwd", "diffusion stencil (ours)"), ("stencil_step", "diffusion stencil (ours)"),
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
    ("copy", "copy"), ("cat", "concat"),
)


def kernel_category(name: str) -> str:
    n = name.lower()
    for key, cat in CATEGORIES:
        if key in n:
            return cat
    return "other"


def stencil_kernels(name: str, direction: str) -> bool:
    """Whether a kernel name is one of the port's diffusion-stencil kernels
    of ``direction`` ("fwd" or "bwd"), by the names in
    ``dgtd_tpu_torch/csrc/diffusion_stencil*.cu``."""
    n = name.lower()
    if "stencil" not in n:
        return False
    is_bwd = "bwd" in n
    return is_bwd if direction == "bwd" else not is_bwd


def main(argv=None) -> int:
    """``python3 -m benchmark.yardstick flops <config> <size>``: print the
    configuration's FLOPs an image at ``size``² as its file stores them."""
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description="Count a configuration's FLOPs an image on the reference.")
    ap.add_argument("what", choices=["flops"])
    ap.add_argument("config")
    ap.add_argument("size", type=int)
    args = ap.parse_args(argv)
    cfg = json.loads((Path(__file__).resolve().parent / "configs" / f"{args.config}.json").read_text())
    print(json.dumps({str(args.size): count_flops(cfg["architecture"], args.size)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
