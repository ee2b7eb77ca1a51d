"""The ``depth`` mode on the CPU at a tiny depther: the cell found by name
from dropped-in files and ``correct`` as it is, not ``correct`` with the
timed path's answer altered, the fp8 control over its limit, the
calibration's readings taken from the set-up's sample alone, and the seven
``depth.*`` readers on a hand-made trace: numbers in the depth mode, None
off it."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import BENCH, make_tiny_root
from benchmark.yardstick import DeviceOp, HostOp, Trace

CELL = "tiny.depther.vitl14.518"
TINY_MODEL = {"arch": "tiny", "out_indices": [0, 1, 2, 3], "classify": True, "n_bins": 16,
              "channels": 16, "post_process_channels": [8, 16, 32, 64], "pretrain_grid": 3}
TINY_ARCH = {"embed_dim": 32, "depth": 4, "num_heads": 2, "mlp_hidden": 128, "pretrain_grid": 3,
             "out_indices": [0, 1, 2, 3], "post_process_channels": [8, 16, 32, 64], "channels": 16, "n_bins": 16}
#: float32 on both sides: the program and the reference differ in the order
#: of their sums only (measured at these widths: 1.2e-6 of the range)
TINY_LIMITS = {"depth_max_gap": {"limit": 1e-4}, "depth_mean_gap": {"limit": 1e-5}}
READERS = ("depth.backbone_ms", "depth.head_ms", "depth.attention_roofline", "depth.mfu", "depth.idle_share",
           "depth.launches", "depth.host_syncs")


def tiny_depther_root(dst):
    root = make_tiny_root(dst)
    cfg = json.loads((BENCH / "configs" / "depther-vitl14-518.json").read_text())
    cfg["name"] = "tiny-depther-vitl14-518"
    cfg["program"]["model"] = dict(TINY_MODEL)
    cfg["program"]["dtype"] = "float32"
    cfg["architecture"].update(TINY_ARCH)
    cfg["flops_per_image"] = {"40x54": {"forward": 1.0e9}}
    (root / "configs" / "tiny-depther-vitl14-518.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny_depth_b32.json").write_text(json.dumps(
        {"mode": "depth", "batch": 2, "size": "40x54", "pool": 2, "warmup": 1, "check_batches": 2,
         "trace_batches": 2}))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return root


@pytest.fixture(scope="module")
def depth_root(tmp_path_factory):
    return tiny_depther_root(tmp_path_factory.mktemp("bench_depth"))


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    """The tiny backbone (width 32, 4 blocks, 2 heads) in the port's table
    as ``tiny``."""
    from dgtd_tpu_torch.models import dinov2

    monkeypatch.setitem(dinov2.DINOV2_ARCHS, "tiny", (32, 4, 2, "mlp"))


def run_cell(root, capsys, trace=0, seed=2 ** 31 + 23):
    from benchmark.run import main

    rc = main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3", "--trace", str(trace)],
              device=torch.device("cpu"), root=root)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_depth_cell_is_correct(depth_root, capsys, trace):
    rc, line, err = run_cell(depth_root, capsys, trace)
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(TINY_LIMITS) and line["attempted"] > 0 and line["failed"] == 0
    if trace == 0:
        assert set(line["metrics"]) >= {"serve_images_per_s", "serve_p95_ms", "setup_s"}
    else:
        # the CPU's trace has no device operation: the device readers find nothing
        assert line["metrics"] == {} and "breakdown" in line
    assert "reference depth maps: 4 images, std" in err


def test_altered_depth_is_not_correct(depth_root, capsys, monkeypatch):
    from dgtd_tpu_torch.tools.depth_gen import Dinov2Depther

    real = Dinov2Depther.batch

    def altered(self, images):
        depth = real(self, images).clone()
        depth[0, :4, :4] += 0.01 * (depth[0].max() - depth[0].min())
        return depth

    monkeypatch.setattr(Dinov2Depther, "batch", altered)
    rc, line, _ = run_cell(depth_root, capsys)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["depth_max_gap"]["value"] > line["checks"]["depth_max_gap"]["limit"]


def test_calibration_reads_the_setup_sample_and_the_control(depth_root):
    from benchmark.calibrate import readings

    cell = harness.Cell(depth_root, harness.load_benchmark(depth_root), CELL)
    out = readings(cell, 2 ** 31 + 41, 0.1, True, torch.device("cpu"), (False, False))
    for k, limit in TINY_LIMITS.items():
        assert out["program"][k] <= limit["limit"] < out["control_fp8"][k], out
    assert out["program_why"]["ref_std_min"] > 0.0


def _trace():
    """One traced batch (units 1), microseconds: the depther's span around
    the backbone (two attention calls inside it) and the head."""
    host = [HostOp("dgtd.depther", 0.0, 100.0, 1, 0), HostOp("dgtd.depther.backbone", 5.0, 60.0, 1, 0),
            HostOp("dgtd.depther.attention", 10.0, 20.0, 1, 0), HostOp("dgtd.depther.attention", 30.0, 40.0, 1, 0),
            HostOp("dgtd.depther.head", 60.0, 95.0, 1, 0),
            HostOp("cudaMemcpyAsync", 2.0, 3.0, 1, 1), HostOp("cudaLaunchKernel", 12.0, 13.0, 1, 2),
            HostOp("cudaLaunchKernel", 32.0, 33.0, 1, 3), HostOp("cudaLaunchKernel", 50.0, 51.0, 1, 4),
            HostOp("cudaLaunchKernel", 70.0, 71.0, 1, 5), HostOp("cudaStreamSynchronize", 120.0, 121.0, 1, 0)]
    dev = [DeviceOp("Memcpy HtoD", 3.0, 5.0, 1), DeviceOp("flash", 13.0, 23.0, 2), DeviceOp("flash", 33.0, 43.0, 3),
           DeviceOp("gemm", 51.0, 70.0, 4), DeviceOp("conv", 71.0, 110.0, 5)]
    return Trace(dev, host, window_s=200e-6, units=1)


@pytest.mark.parametrize("mode", ["depth", "serve", "train"])
def test_depth_readers_read_only_their_mode(depth_root, mode):
    cfg = json.loads((depth_root / "configs" / "tiny-depther-vitl14-518.json").read_text())
    traffic = json.loads((depth_root / "traffic" / "tiny_depth_b32.json").read_text())
    cell = types.SimpleNamespace(mode=mode, config=cfg, traffic=traffic)
    run = types.SimpleNamespace(cell=cell, trace=_trace(), device=torch.device("cuda", 0), readings={"images": 2})
    got = {m: harness.load_module(BENCH, "metrics", m).read(run) for m in READERS}
    if mode != "depth":
        assert got == dict.fromkeys(READERS)
        return
    flops = 4.0 * 2 * (3 * 4 + 1) ** 2 * 32 * 4
    assert got == pytest.approx({
        "depth.backbone_ms": 0.039, "depth.head_ms": 0.039,
        "depth.attention_roofline": 100.0 * flops / 20e-6 / 989e12,
        "depth.mfu": 100.0 * 1.0e9 * 2 / 200e-6 / 989e12,
        "depth.idle_share": 100.0 * (1.0 - 80e-6 / 200e-6),
        "depth.launches": 4.0, "depth.host_syncs": 0.0})
