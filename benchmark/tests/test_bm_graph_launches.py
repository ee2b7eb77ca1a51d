"""``train.graph_launches`` on hand-made traces: the ``cudaGraphLaunch``
runtime calls started inside ``dgtd.train.step`` on any thread, a step;
kernel launches and calls outside the step are not counted; None where
there is nothing to read."""

from __future__ import annotations

import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import BENCH
from benchmark.yardstick import DeviceOp, HostOp, Trace

MAIN, AUTOGRAD = 1, 2


def read(trace):
    return harness.load_module(BENCH, "metrics", "train.graph_launches").read(types.SimpleNamespace(trace=trace))


def _replayed_trace():
    """Two replayed steps (units 2), microseconds: in each, a copy into the
    static inputs, then the forward, backward and optimizer graphs launched
    from the main thread, a clone and a fill between them; one graph launch
    after the second step and one kernel from autograd's thread in the first."""
    host, dev = [], []
    for i, t0 in enumerate((0.0, 100.0)):
        c = 10 * i
        host += [HostOp("dgtd.train.step", t0, t0 + 90.0, MAIN, 0),
                 HostOp("cudaMemcpyAsync", t0 + 1.0, t0 + 2.0, MAIN, c + 1),
                 HostOp("cudaGraphLaunch", t0 + 5.0, t0 + 6.0, MAIN, c + 2),
                 HostOp("cudaLaunchKernel", t0 + 7.0, t0 + 8.0, MAIN, c + 3),
                 HostOp("cudaGraphLaunch_v10000", t0 + 30.0, t0 + 31.0, MAIN, c + 4),
                 HostOp("cudaLaunchKernel", t0 + 60.0, t0 + 61.0, MAIN, c + 5),
                 HostOp("cudaGraphLaunch", t0 + 62.0, t0 + 63.0, MAIN, c + 6)]
        dev += [DeviceOp("Memcpy DtoD", t0 + 2.0, t0 + 3.0, c + 1), DeviceOp("fwd", t0 + 6.0, t0 + 29.0, c + 2),
                DeviceOp("clone", t0 + 29.0, t0 + 30.0, c + 3), DeviceOp("bwd", t0 + 31.0, t0 + 59.0, c + 4),
                DeviceOp("fill", t0 + 61.0, t0 + 62.0, c + 5), DeviceOp("adam", t0 + 63.0, t0 + 70.0, c + 6)]
    host += [HostOp("cudaLaunchKernel", 40.0, 41.0, AUTOGRAD, 50), HostOp("cudaGraphLaunch", 195.0, 196.0, MAIN, 51)]
    dev += [DeviceOp("k", 41.0, 42.0, 50), DeviceOp("after", 196.0, 199.0, 51)]
    return Trace(dev, host, 200e-6, 2)


def test_counts_graph_launches_inside_the_step_only():
    t = _replayed_trace()
    # 3 a step, the versioned name included; not the launch at 195
    assert read(t) == pytest.approx(3.0)
    # the kernel launches beside them are train.launches', not these
    assert harness.load_module(BENCH, "metrics", "train.launches").read(
        types.SimpleNamespace(trace=t)) == pytest.approx(5 / 2)


def test_an_eager_step_reads_zero_and_nothing_to_read_reads_none():
    t = _replayed_trace()
    eager = Trace(t.device_ops, [h for h in t.host_ops if "GraphLaunch" not in h.name], t.window_s, 2)
    assert read(eager) == 0.0
    assert read(None) is None
    assert read(Trace([], t.host_ops, t.window_s, 2)) is None
    assert read(Trace(t.device_ops, [h for h in t.host_ops if not h.name.startswith("dgtd.")], t.window_s, 2)) is None


def test_declared_for_the_train_cells():
    bench = harness.load_benchmark(BENCH)
    m = {m["name"]: m for m in bench["per_layer"]}["train.graph_launches"]
    assert m["layer"] == "train step dispatch (span dgtd.train.step)" and m["moves"] == "train_images_per_s"
    assert m["workloads"] == ["cod.train.b20", "dqnet.train.b32"] and m["source"] == "device_trace"
