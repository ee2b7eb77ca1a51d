"""On the card (``-m cuda``): the control of each cell, at a batch that a
test run holds, fails the cell's limits; a traced tiny run reads device
time, the stencil kernels by name, the prompt encoder's range and the
optimizer's."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import compare, harness
from benchmark.inputs import make_pool
from benchmark.tests.conftest import BENCH

#: the control's batch in this test (the cells run 20 and 64)
TEST_BATCH = {"train": 4, "serve": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cod.train.b20", "cod.serve.b64", "dqnet.train.b32", "dqnet.serve.b128"])
def test_control_fails_the_limits(cuda_device, workload):
    from benchmark.run import Run

    cell = harness.Cell(BENCH, harness.load_benchmark(BENCH), workload)
    cell.traffic = dict(cell.traffic, batch=TEST_BATCH[cell.mode], pool=3)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, 2 ** 31 + 77, 1.0, False, cuda_device)
    driver = cell.driver()(run)
    driver.pool = make_pool(run.seed, 3, driver.batch, driver.size, labels=cell.mode == "train", pin=True)
    driver.sample = [(0, None), (1, None)]
    ref = driver.reference_readings("fp32")
    checks = compare.judge(driver.numbers(ref, driver.reference_readings("fp8")), cell.limits)
    assert not compare.correct(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.cod.train.b20", "tiny.cod.serve.b64"])
def test_traced_tiny_run_reads_the_card(cuda_device, tiny_root, capsys, workload):
    from benchmark.run import main

    rc = main(["--workload", workload, "--seed", "5", "--seconds", "1", "--trace", "1"], device=cuda_device,
              root=tiny_root)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    roofline = "train.stencil_roofline" if ".train." in workload else "serve.stencil_roofline"
    assert 0 < line["metrics"][roofline]["value"] < 105
    if ".serve." in workload:
        assert line["metrics"]["serve.prompt_encoder_ms"]["value"] > 0
    else:
        assert line["metrics"]["train.optim_ms"]["value"] > 0
    assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
