"""What the span readers share: the program's named spans (``record_function``
ranges that ``dgtd_tpu_torch/core/trace.py`` opens, ``dgtd.*``) read from a
traced run's :class:`~benchmark.yardstick.Trace`.

The rule that puts device work down to a span: an operation on the device
belongs to a span when the runtime call that launched it (kernel launch,
copy or set; matched to the operation by correlation id) starts inside one
of the span's host intervals, on **any** thread of the process. On CUDA
``loss.backward()`` launches its kernels from autograd's device thread
while the calling thread waits inside ``dgtd.train.backward``; a rule that
kept to the span's own thread (``Trace.range_device_s``) would read 0 there.

Every reader returns None without a trace, on a trace with no device
operation (the CPU's), or where the trace has no such span (a program
that opens none): the line then leaves the metric out.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, List, Optional, Tuple

from benchmark.yardstick import Trace

#: the runtime calls that launch a kernel (CUDA runtime and driver API)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchCooperativeKernel")
#: the runtime calls that block the host until the device has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

_SUFFIX = re.compile(r"(_v\d+|_ptsz|_ptds)+$")


def base_name(name: str) -> str:
    """A runtime call's name without CUPTI's version or per-thread-stream
    suffixes (``cudaLaunchKernelExC_v11060`` -> ``cudaLaunchKernelExC``)."""
    return _SUFFIX.sub("", name)


def is_kernel_launch(name: str) -> bool:
    return base_name(name) in KERNEL_LAUNCHES


def is_host_sync(name: str) -> bool:
    """A blocking call: a synchronize, or a ``cudaMemcpy`` that is not
    ``Async``."""
    b = base_name(name)
    return b in BLOCKING or (b.startswith("cudaMemcpy") and "Async" not in b)


def puts_work(name: str) -> bool:
    """A runtime call that puts an operation on the device: a launch, a
    copy or a set."""
    return "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))


def intervals(trace: Trace, label: str) -> List[Tuple[float, float]]:
    """The host intervals of the spans named ``label``, on any thread,
    overlaps merged (microseconds, sorted)."""
    out: List[List[float]] = []
    for h in sorted((h for h in trace.host_ops if h.name == label), key=lambda h: h.start):
        if out and h.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], h.end)
        else:
            out.append([h.start, h.end])
    return [(a, b) for a, b in out]


def _inside(t: float, ivs: List[Tuple[float, float]], starts: List[float]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def _span(run, label: str) -> Optional[List[Tuple[float, float]]]:
    """The span's intervals, or None where there is nothing to read."""
    trace = run.trace
    if trace is None or not trace.device_ops:
        return None
    return intervals(trace, label) or None


def calls(run, label: str, match: Callable[[str], bool]) -> Optional[float]:
    """Runtime calls that ``match`` accepts, a traced unit, started inside
    the span ``label`` on any thread."""
    ivs = _span(run, label)
    if ivs is None:
        return None
    starts = [a for a, _ in ivs]
    n = sum(1 for h in run.trace.host_ops if match(h.name) and _inside(h.start, ivs, starts))
    return n / run.trace.units


def device_ms(run, label: str) -> Optional[float]:
    """Device ms a traced unit of the operations launched inside the span
    ``label`` (any thread, by correlation id), their intervals united."""
    ivs = _span(run, label)
    if ivs is None:
        return None
    trace = run.trace
    starts = [a for a, _ in ivs]
    corrs = {h.corr for h in trace.host_ops if h.corr > 0 and puts_work(h.name) and _inside(h.start, ivs, starts)}
    ops = [o for o in trace.device_ops if o.corr in corrs]
    return Trace(ops, [], trace.window_s, trace.units).busy_s() * 1e3 / trace.units


def idle_ms(run, label: str) -> Optional[float]:
    """The device's idle ms a traced unit inside the span ``label``'s host
    intervals: each interval's length less the union of the device's
    operations (all of them, whoever launched them) over it."""
    ivs = _span(run, label)
    if ivs is None:
        return None
    busy = run.trace.busy_intervals()
    ends = [b for _, b in busy]
    idle = 0.0
    for a, b in ivs:
        covered = 0.0
        i = bisect.bisect_right(ends, a)
        while i < len(busy) and busy[i][0] < b:
            covered += min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
        idle += (b - a) - covered
    return idle * 1e-3 / run.trace.units
