"""The frozen reference against the port at tiny widths on the CPU, in
float32: the forward, and three train steps (each step's losses, the first
gradient, the parameters after three AdamW steps with the recipe's lr
multipliers and DropPath on). The seeded state dict loads into both."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from benchmark import compare, program
from benchmark.inputs import make_pool, reference_batch
from benchmark.reference.adamw import train_steps
from benchmark.reference.models import probability
from benchmark.reference.numerics import Numerics
from benchmark.tests.conftest import tiny_config
from benchmark.weights import make_state, n_parameters

CONFIGS = ["cod-pvtb2-384", "dqnet-pvtb2-384"]


def _ref_optim(cfg):
    keys = cfg["program"]["optim_wrapper"]["paramwise_cfg"]["custom_keys"]
    return {"optimizer": cfg["program"]["optim_wrapper"]["optimizer"],
            "custom_keys": {k: (v["lr_mult"] if isinstance(v, dict) else v) for k, v in keys.items()}}


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_port(name):
    cfg = tiny_config(name)
    state = make_state(cfg["architecture"], 2 ** 31 + 17, "cpu")
    model = program.build_model(cfg["program"], state, torch.device("cpu"))
    assert n_parameters(cfg["architecture"]) == sum(p.numel() for p in model.parameters())
    batch = make_pool(3, 1, 2, 64, labels=False, pin=False)[0]
    host, _ = program.serve_call(model, batch, torch.device("cpu"))
    rb = reference_batch(batch, "cpu")
    ref = probability(cfg["architecture"], state, rb["input"], rb["depth"]).permute(0, 2, 3, 1)
    torch.testing.assert_close(host, ref, rtol=0, atol=1e-6)
    control = probability(cfg["architecture"], state, rb["input"], rb["depth"], Numerics("fp8")).permute(0, 2, 3, 1)
    assert (control - ref).abs().max() > 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_match_port(name):
    cfg = tiny_config(name)
    seed = 2 ** 31 + 5
    arch, prog = cfg["architecture"], cfg["program"]
    state = make_state(arch, seed, "cpu")
    model = program.build_model(prog, state, torch.device("cpu"))
    opt = program.build_optimizer(prog, model)
    pool = make_pool(seed, 3, 4, 64, labels=True, pin=False)
    losses = []
    for step, batch in enumerate(pool):
        losses.append({k: float(v) for k, v in program.train_call(model, opt, batch, step, seed, "cpu").items()})
        if step == 0:
            grads = {n: m / (1 - program.betas(opt)[0]) for n, m in program.first_moments(model, opt).items()}
    ref_grads = {}

    def on_grads(step, g):
        if step == 0:
            ref_grads.update(g)

    P = make_state(arch, seed, "cpu")
    ref_losses = train_steps(arch, _ref_optim(cfg), prog["schedule"], P, [reference_batch(b, "cpu") for b in pool],
                             seed, on_grads=on_grads)
    for got, want in zip(losses, ref_losses):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5)
    assert set(grads) == set(ref_grads)
    for n in grads:
        torch.testing.assert_close(grads[n], ref_grads[n], rtol=1e-3, atol=1e-6)
    # AdamW moves an element whose gradient is near 0 by its sign: the
    # parameters are compared as the harness compares them, leaf norms of
    # the change
    start = make_state(arch, seed, "cpu")
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    ref_change = {n: float((P[n] - start[n]).norm()) for n in change}
    numbers = compare.train_numbers(
        {"losses": [x["loss"] for x in losses], "grad_norms": {n: float(g.norm()) for n, g in grads.items()},
         "change_norms": change},
        {"losses": [x["loss"] for x in ref_losses], "grad_norms": {n: float(g.norm()) for n, g in ref_grads.items()},
         "change_norms": ref_change})
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-2, numbers


def test_reference_imports_nothing_of_the_program():
    for path in sorted((Path(__file__).resolve().parents[1] / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "typing", "__future__"), (path.name, n)
