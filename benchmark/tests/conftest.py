"""Fixtures of the benchmark's own tests.

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m cuda    # on the card

``tiny_root`` is a copy of the benchmark folder beside a ``BENCHMARK.json``
of its own whose four cells are the real ones at tiny widths, in float32,
on 64² inputs: new configuration, traffic and limit files dropped in by
name, no file of the benchmark edited. Tests that need the card take the
``cuda_device`` fixture, which skips without one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_PVT = {"embed_dims": [8, 16, 32, 64], "num_heads": [1, 2, 4, 8], "mlp_ratios": [2, 2, 2, 2],
            "depths": [1, 1, 1, 1], "sr_ratios": [8, 4, 2, 1]}
#: limits of the tiny float32 cells: the program and the reference differ
#: in the order of their sums only (measured: losses 1e-7, gradient norms
#: 6e-7, changes under AdamW 1.2e-4 of the median leaf)
TINY_LIMITS = {"train": {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-4}, "grad_diff": {"limit": 1e-4},
                         "change_gap": {"limit": 1e-2}},
               "serve": {"prob_max_gap": {"limit": 1e-4}, "prob_mean_gap": {"limit": 1e-5}}}


def tiny_config(name: str) -> dict:
    """A benchmark configuration cut to tiny widths, in float32."""
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c["program"]["dtype"] = "float32"
    c["name"] = f"tiny-{name}"
    if c["program"]["model"]["type"] == "cod":
        c["program"]["model"].update(variant="tiny", channel=8, refine_iters=2, latent_dim=8, grid=8,
                                     convnext_dims=[8, 16, 32, 64], convnext_depths=[1, 1, 1, 1])
        c["architecture"].update(pvt=TINY_PVT, channel=8, refine_iters=2)
        c["architecture"]["prompt"].update(latent_dim=8, grid=8, convnext_dims=[8, 16, 32, 64],
                                           convnext_depths=[1, 1, 1, 1])
    else:
        c["program"]["model"].update(variant="tiny", channel=8, cross_size=11)
        c["architecture"].update(pvt=TINY_PVT, channel=8, cross_size=11)
    c["flops_per_image"] = {}
    return c


def make_tiny_root(dst: Path) -> Path:
    """The tiny copy under ``dst``; returns its benchmark folder."""
    root = dst / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("cod-pvtb2-384", "dqnet-pvtb2-384"):
        (root / "configs" / f"tiny-{name}.json").write_text(json.dumps(tiny_config(name)))
    for path in sorted((BENCH / "traffic").glob("*.json")):
        tr = json.loads(path.read_text())
        tr.update(batch=4, size=64, trace_steps=2, trace_batches=2, enqueue_reps=2)
        (root / "traffic" / f"tiny_{path.name}").write_text(json.dumps(tr))
    workloads = []
    for w in bench["workloads"]:
        w = dict(w, name=f"tiny.{w['name']}", config=f"tiny-{w['config']}", traffic=f"tiny_{w['traffic']}")
        workloads.append(w)
        mode = "train" if ".train." in w["name"] else "serve"
        (root / "limits" / f"{w['name']}.json").write_text(json.dumps(TINY_LIMITS[mode]))
    bench["workloads"] = workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny.{x}" for x in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
