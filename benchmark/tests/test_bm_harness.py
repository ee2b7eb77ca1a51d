"""The harness on the CPU: ``BENCHMARK.json`` against the format's rules, the
import guard, cells found by name from dropped-in files, the result line's
keys, and ``correct`` on the tiny cells, true as they are and false with
the timed path broken underneath (a step that leaves the state unchanged,
half of the batch left out, a served answer altered)."""

from __future__ import annotations

import json
import math
import re
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(root, capsys, workload, trace=0, seed=2 ** 31 + 11):
    from benchmark.run import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)],
              device=torch.device("cpu"), root=root)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


def test_benchmark_json_meets_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"] == []
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"]) <= 24
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        mode = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["mode"]
        assert (BENCH / "drivers" / f"{mode}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for name in cells:
        cell = harness.Cell(BENCH, bench, name)
        e2e = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.metrics("per_layer")
    assert len(json.dumps(bench)) < 64 * 1024


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dgtd_tpu_torch_probe", types.ModuleType("dgtd_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxlibrary", types.ModuleType("jaxlibrary"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "dgtd_tpu", types.ModuleType("dgtd_tpu"))
    assert harness.forbidden_modules() == ["dgtd_tpu", "jax"]


@pytest.mark.parametrize("when", ["before_the_run", "in_the_reference_check"])
def test_run_refuses_with_jax_loaded(tiny_root, capsys, monkeypatch, when):
    from benchmark.run import main

    if when == "before_the_run":
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    else:
        real = harness.Cell.driver

        def loading_driver(self):
            class Loading(real(self)):
                def reference_readings(self, *a, **k):
                    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
                    return super().reference_readings(*a, **k)

            return Loading

        monkeypatch.setattr(harness.Cell, "driver", loading_driver)
    rc = main(["--workload", "tiny.cod.serve.b64", "--seed", "1", "--seconds", "0.1"], device=torch.device("cpu"),
              root=tiny_root)
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "flax" in out.err


def test_traced_train_steps_range_the_optimizer(tiny_root):
    from benchmark.drivers.train import OPTIMIZER_RANGE
    from benchmark.run import Run

    cell = harness.Cell(tiny_root, harness.load_benchmark(tiny_root), "tiny.dqnet.train.b32")
    run = Run(cell, 3, 0.1, True, torch.device("cpu"))
    driver = cell.driver()(run)
    driver.setup()
    assert driver.traced() == cell.traffic["trace_steps"]
    ranges = [h for h in run.trace.host_ops if h.name == OPTIMIZER_RANGE]
    assert len(ranges) == cell.traffic["trace_steps"]
    assert "step" not in vars(driver.opt)


@pytest.mark.parametrize("workload", ["tiny.cod.train.b20", "tiny.cod.serve.b64", "tiny.dqnet.train.b32",
                                      "tiny.dqnet.serve.b128"])
def test_tiny_cells_are_correct(tiny_root, capsys, workload):
    rc, line, err = run_cell(tiny_root, capsys, workload)
    assert rc == 0 and set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) >= {"setup_s"} and line["attempted"] > 0 and line["failed"] == 0
    assert err.strip().splitlines()[-1].startswith("check ")


def test_dropped_in_files_are_found_by_name(tmp_path, capsys):
    from benchmark.tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    (root / "traffic" / "tiny_serve_b2.json").write_text(json.dumps(
        {"mode": "serve", "batch": 2, "size": 64, "pool": 2, "warmup": 1, "check_batches": 1, "trace_batches": 2,
         "enqueue_reps": 1}))
    (root / "metrics" / "serve.batches_traced.py").write_text(
        "def read(run):\n    return float(run.trace.units) if run.trace is not None else None\n")
    (root / "limits" / "tiny.dqnet.serve.b2.json").write_text(
        json.dumps({"prob_max_gap": {"limit": 1e-4}, "prob_mean_gap": {"limit": 1e-5}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.dqnet.serve.b2", "config": "tiny-dqnet-pvtb2-384",
                               "traffic": "tiny_serve_b2", "chips": 1, "why": "a cell added by files alone"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.dqnet.serve.b128" in m["workloads"]:
            m["workloads"].append("tiny.dqnet.serve.b2")
    bench["per_layer"].append({"name": "serve.batches_traced", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "serve_images_per_s",
                               "workloads": ["tiny.dqnet.serve.b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, _ = run_cell(root, capsys, "tiny.dqnet.serve.b2", trace=1)
    assert rc == 0 and line["correct"] is True
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert line["metrics"]["serve.batches_traced"] == {"value": 2.0, "unit": "batches"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}


def _unchanged_step(self, step):
    self.opt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("workload", ["tiny.cod.train.b20", "tiny.dqnet.train.b32"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_faults_are_not_correct(tiny_root, capsys, monkeypatch, workload, fault):
    from benchmark import program
    from dgtd_tpu_torch.train.optim import Optimizer

    if fault == "state_unchanged":
        monkeypatch.setattr(Optimizer, "step", _unchanged_step)
    else:
        real = program.train_step

        def half(model, opt, batch, step, seed):
            return real(model, opt, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, step, seed)

        monkeypatch.setattr(program, "train_step", half)
    rc, line, _ = run_cell(tiny_root, capsys, workload)
    assert rc == 0 and line["correct"] is False
    failing = [n for n, c in line["checks"].items() if not (isinstance(c["value"], float) and c["value"] <= c["limit"])]
    assert failing
    if fault == "state_unchanged":
        assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["tiny.cod.serve.b64", "tiny.dqnet.serve.b128"])
def test_altered_answer_is_not_correct(tiny_root, capsys, monkeypatch, workload):
    from dgtd_tpu_torch.models.cod import SegModel

    real = SegModel.predict

    def altered(self, image, depth, out_size=None):
        prob, extra = real(self, image, depth, out_size)
        prob = prob.clone()
        prob[0, :8, :8] = 1.0 - prob[0, :8, :8]
        return prob, extra

    monkeypatch.setattr(SegModel, "predict", altered)
    rc, line, _ = run_cell(tiny_root, capsys, workload)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["prob_max_gap"]["value"] > line["checks"]["prob_max_gap"]["limit"]


def test_non_finite_numbers_are_not_correct():
    from benchmark import compare

    checks = compare.judge({"loss_gap": math.nan}, {"loss_gap": {"limit": 1.0}, "grad_gap": {"limit": 1.0}})
    assert not compare.correct(checks)
    assert harness.plain(math.inf) == "inf"
