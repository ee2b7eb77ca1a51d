"""The span readers (``metrics/_spans.py`` and the metrics that use it) on
hand-made traces: device work put down to a span by the launching call's
correlation id on any thread, idle time inside a span's host intervals,
launch and sync calls counted inside the step or the served batch only,
None where there is nothing to read; and, on the card (``-m cuda``), a
real traced tiny train step."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.tests.conftest import BENCH
from benchmark.yardstick import DeviceOp, HostOp, Trace

NEW = ("train.forward_ms", "train.backward_ms", "train.forward_idle_ms", "train.backward_idle_ms",
       "train.launches", "train.host_syncs", "serve.launches", "serve.backbone_ms", "serve.decode_ms",
       "serve.prompt_decoders_ms")
MAIN, AUTOGRAD = 1, 2


def read(metric: str, trace):
    return harness.load_module(BENCH, "metrics", metric).read(types.SimpleNamespace(trace=trace))


def _train_trace():
    """Two steps' worth of events in one (units 2), microseconds: the
    forward launches from the main thread, the backward from autograd's."""
    host = [HostOp("dgtd.train.step", 0.0, 100.0, MAIN, 0),
            HostOp("dgtd.train.forward", 5.0, 40.0, MAIN, 0),
            HostOp("dgtd.train.backward", 45.0, 80.0, MAIN, 0),
            HostOp("dgtd.train.optimizer", 82.0, 95.0, MAIN, 0),
            HostOp("cudaLaunchKernel", 10.0, 11.0, MAIN, 1),
            HostOp("cudaLaunchKernel", 20.0, 21.0, MAIN, 2),
            HostOp("cudaMemcpyAsync", 30.0, 30.5, MAIN, 7),
            HostOp("cudaLaunchKernel", 50.0, 51.0, AUTOGRAD, 3),
            HostOp("cudaLaunchKernelExC_v11060", 60.0, 61.0, AUTOGRAD, 4),
            HostOp("cudaMemcpy", 70.0, 72.5, AUTOGRAD, 8),
            HostOp("cuLaunchKernel", 85.0, 86.0, MAIN, 5),
            HostOp("cudaStreamSynchronize", 90.0, 91.0, MAIN, 0),
            HostOp("cudaLaunchKernel", 105.0, 106.0, MAIN, 6),
            HostOp("cudaStreamSynchronize", 110.0, 111.0, MAIN, 0)]
    dev = [DeviceOp("k1", 12.0, 18.0, 1), DeviceOp("k2", 22.0, 45.0, 2), DeviceOp("Memcpy HtoD", 31.0, 33.0, 7),
           DeviceOp("bk3", 52.0, 58.0, 3), DeviceOp("bk4", 62.0, 70.0, 4), DeviceOp("Memcpy DtoH", 71.0, 72.0, 8),
           DeviceOp("adam", 87.0, 89.0, 5), DeviceOp("after", 106.0, 108.0, 6)]
    return Trace(dev, host, 120e-6, 2)


def test_backward_counts_kernels_launched_from_another_thread():
    t = _train_trace()
    # k3, k4 and the copy, all from autograd's thread: 6 + 8 + 1 us over 2 steps
    assert read("train.backward_ms", t) == pytest.approx(15e-3 / 2)
    # the span's own thread launched nothing: the same-thread rule reads 0
    assert t.range_device_s("dgtd.train.backward") == 0.0
    # k1, k2 united with the copy inside it (22..45): 6 + 23 us
    assert read("train.forward_ms", t) == pytest.approx(29e-3 / 2)


def test_idle_is_read_inside_the_span_only():
    t = _train_trace()
    # forward 5..40 (35 us): busy 12..18 and 22..40, idle 11 us
    assert read("train.forward_idle_ms", t) == pytest.approx(11e-3 / 2)
    # backward 45..80 (35 us): busy 52..58, 62..70, 71..72, idle 20 us; the
    # gap 40..45 lies in no phase and 80..87 in none either
    assert read("train.backward_idle_ms", t) == pytest.approx(20e-3 / 2)
    # two forward spans (one a step) add up
    two = Trace(t.device_ops, t.host_ops + [HostOp("dgtd.train.forward", 100.0, 110.0, MAIN, 0)], t.window_s, 2)
    assert read("train.forward_idle_ms", two) == pytest.approx((11 + 8) * 1e-3 / 2)


def test_launches_and_syncs_are_counted_inside_the_step_only():
    t = _train_trace()
    # the launches at 10, 20, 50, 60 and 85; not the one at 105
    assert read("train.launches", t) == pytest.approx(5 / 2)
    # the synchronize at 90 and the blocking cudaMemcpy at 70; not the
    # cudaMemcpyAsync, not the synchronize at 110
    assert read("train.host_syncs", t) == pytest.approx(2 / 2)
    serve = Trace(t.device_ops, t.host_ops + [HostOp("dgtd.predict", 45.0, 88.0, MAIN, 0)], t.window_s, 1)
    # 50, 60, 85 inside dgtd.predict
    assert read("serve.launches", serve) == pytest.approx(3.0)
    no_syncs = Trace(t.device_ops, [h for h in t.host_ops if not _spans.is_host_sync(h.name)], t.window_s, 2)
    assert read("train.host_syncs", no_syncs) == 0.0


def test_serve_spans_split_a_batch():
    host = [HostOp("dgtd.predict", 0.0, 50.0, MAIN, 0), HostOp("dgtd.prompt_decoders", 1.0, 9.0, MAIN, 0),
            HostOp("dgtd.backbone", 10.0, 30.0, MAIN, 0), HostOp("dgtd.decode", 31.0, 45.0, MAIN, 0),
            HostOp("cudaLaunchKernel", 2.0, 3.0, MAIN, 1), HostOp("cudaLaunchKernel", 12.0, 13.0, MAIN, 2),
            HostOp("cudaLaunchKernel", 14.0, 15.0, MAIN, 3), HostOp("cudaLaunchKernel", 40.0, 41.0, MAIN, 4)]
    dev = [DeviceOp("a", 4.0, 20.0, 1), DeviceOp("b", 20.0, 40.0, 2), DeviceOp("c", 40.0, 44.0, 3),
           DeviceOp("d", 44.0, 50.0, 4)]
    t = Trace(dev, host, 60e-6, 2)
    assert read("serve.prompt_decoders_ms", t) == pytest.approx(16e-3 / 2)
    # b and c, queued behind a: device time, not the span's host interval
    assert read("serve.backbone_ms", t) == pytest.approx(24e-3 / 2)
    assert read("serve.decode_ms", t) == pytest.approx(6e-3 / 2)
    assert read("serve.launches", t) == pytest.approx(4 / 2)


def test_runtime_call_names():
    assert _spans.is_kernel_launch("cudaLaunchKernelExC_v11060") and _spans.is_kernel_launch("cuLaunchKernel")
    assert not _spans.is_kernel_launch("cudaGraphLaunch") and not _spans.is_kernel_launch("aten::add")
    assert _spans.is_host_sync("cudaMemcpy") and _spans.is_host_sync("cudaEventSynchronize")
    assert not _spans.is_host_sync("cudaMemcpyAsync") and not _spans.is_host_sync("cudaStreamWaitEvent")


@pytest.mark.parametrize("metric", NEW)
def test_every_reader_is_none_without_its_span(metric):
    t = _train_trace()
    spanless = Trace(t.device_ops, [h for h in t.host_ops if not h.name.startswith("dgtd.")], t.window_s, 2)
    assert read(metric, spanless) is None
    assert read(metric, None) is None
    # a CPU trace: the spans, no device operation
    assert read(metric, Trace([], t.host_ops, t.window_s, 2)) is None


def test_new_metrics_are_declared_with_their_cells():
    bench = harness.load_benchmark(BENCH)
    declared = {m["name"]: m for m in bench["per_layer"]}
    train, serve = ["cod.train.b20", "dqnet.train.b32"], ["cod.serve.b64", "dqnet.serve.b128"]
    for name in NEW:
        m = declared[name]
        assert m["source"] == "device_trace" and "(span dgtd." in m["layer"]
        want = train if name.startswith("train.") else ["cod.serve.b64"] if "prompt" in name else serve
        assert m["workloads"] == want


@pytest.mark.parametrize("workload", ["tiny.cod.train.b20", "tiny.dqnet.serve.b128"])
def test_cpu_traced_run_records_the_spans_and_reports_none_of_their_metrics(tiny_root, workload):
    from benchmark.run import Run

    cell = harness.Cell(tiny_root, harness.load_benchmark(tiny_root), workload)
    run = Run(cell, 2 ** 31 + 5, 0.1, True, torch.device("cpu"))
    driver = cell.driver()(run)
    driver.setup()
    units = driver.traced()
    step = "dgtd.train.step" if cell.mode == "train" else "dgtd.predict"
    assert len(_spans.intervals(run.trace, step)) == units
    assert _spans.intervals(run.trace, "dgtd.backbone") and _spans.intervals(run.trace, "dgtd.decode")
    for m in cell.metrics("per_layer"):
        if m["name"] in NEW:
            assert cell.reader(m["name"])(run) is None


@pytest.mark.cuda
def test_traced_tiny_train_step_reads_the_backward(cuda_device, tiny_root, capsys):
    from benchmark.run import main

    rc = main(["--workload", "tiny.cod.train.b20", "--seed", "7", "--seconds", "1", "--trace", "1"],
              device=cuda_device, root=tiny_root)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert rc == 0 and metrics["train.backward_ms"] > 0 and metrics["train.forward_ms"] > 0
    assert metrics["train.launches"] > 0 and metrics["train.host_syncs"] >= 0
    busy_ms = line["device"]["busy_s"] * 1e3 / 2
    assert metrics["train.forward_ms"] + metrics["train.backward_ms"] <= busy_ms * 1.0001
