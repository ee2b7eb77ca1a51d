"""Train mode: back-to-back train steps of the port, closed loop.

Set-up builds one object, the model with its optimizer, from the seeded
weights, and drives it through steps 0–2 by the window's own call and feed
(``program.train_call`` on pinned uint8 batches), on three batches whose
rows all differ; those steps are the warm-up, and what the reference
follows: each step's loss, the first step's gradient as AdamW got it (its
first moment over 1 − β₁) and, before step 3 runs, each parameter's value.
The window then goes on from step 3 with the same object, cycling through
the pool, for ``--seconds``: ``train_images_per_s`` is every image it
trained over all its time, the card synchronised at its end.

Traffic keys, all required: ``batch``, ``size``, ``pool`` (distinct
batches, at least 3), ``trace_steps`` (steps profiled in a traced run),
``enqueue_reps``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from benchmark import compare, program
from benchmark.inputs import make_pool, reference_batch
from benchmark.reference.adamw import train_steps
from benchmark.reference.numerics import Numerics
from benchmark.weights import make_state

CHECK_STEPS = 3
#: label of the range opened around the optimizer's step in a traced run
OPTIMIZER_RANGE = "bench.optimizer"


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = sorted(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]).cpu().tolist()
    return {n: v * scale for n, v in zip(names, vals)}


def _moving(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The elements whose first reference gradient is at least
    ``compare.NEGLIGIBLE_GRAD`` of the median leaf's root-mean-square
    gradient."""
    rms = sorted(float(g.norm()) / max(g.numel(), 1) ** 0.5 for g in grads.values())
    floor = compare.NEGLIGIBLE_GRAD * rms[len(rms) // 2]
    return {n: g.abs() >= floor for n, g in grads.items()}


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.cell.traffic
        self.batch, self.size, self.pool_size = int(t["batch"]), int(t["size"]), int(t["pool"])
        if self.pool_size < CHECK_STEPS:
            raise ValueError(f"a train pool needs at least {CHECK_STEPS} distinct batches")
        self.arch = run.cell.config["architecture"]
        self.prog_cfg = run.cell.config["program"]
        self.step = 0
        self.readings: Optional[dict] = None
        #: per leaf, the elements whose change is compared (``compare``)
        self.mask: Optional[Dict[str, torch.Tensor]] = None

    # -- the program -------------------------------------------------------

    def setup(self) -> None:
        run = self.run
        dev = run.device
        state = make_state(self.arch, run.seed, dev)
        self.model = program.build_model(self.prog_cfg, state, dev)
        del state
        self.opt = program.build_optimizer(self.prog_cfg, self.model)
        self.pool = make_pool(run.seed, self.pool_size, self.batch, self.size, labels=True, pin=dev.type == "cuda")
        losses = []
        for s in range(CHECK_STEPS):
            losses.append(self.call())
            if s == 0:
                scale = 1.0 / (1.0 - program.betas(self.opt)[0])
                moments = program.first_moments(self.model, self.opt)
                grad_norms = _norms(moments, scale)
                grads = {n: (m * scale).to("cpu") for n, m in moments.items()}
        params = {n: p.detach().to("cpu", copy=True) for n, p in self.model.named_parameters()}
        self.readings = {"losses": [float(x["loss"]) for x in losses], "grad_norms": grad_norms, "grads": grads,
                         "params": params}
        run.sync()

    def call(self):
        out = program.train_call(self.model, self.opt, self.pool[self.step % self.pool_size], self.step,
                                 self.run.seed, self.run.device)
        self.step += 1
        return out

    def window(self):
        run = self.run
        run.sync()
        first = self.step
        marks = [time.perf_counter()]
        while marks[-1] - marks[0] < run.seconds:
            self.call()
            marks.append(time.perf_counter())
        run.sync()
        elapsed = time.perf_counter() - marks[0]
        steps = self.step - first
        run.readings["unit_s"] = [b - a for a, b in zip(marks, marks[1:])]
        return steps, 0, {"train_images_per_s": steps * self.batch / elapsed}

    def traced(self) -> int:
        """The host ms of ``enqueue_reps`` steps, each begun after a
        synchronise; then ``trace_steps`` steps under the profiler, the
        optimizer instance's ``step`` wrapped in the range
        ``OPTIMIZER_RANGE`` (put back after)."""
        run = self.run
        host = []
        for _ in range(int(run.cell.traffic["enqueue_reps"])):
            run.sync()
            t0 = time.perf_counter()
            self.call()
            host.append((time.perf_counter() - t0) * 1e3)
        run.readings["train_enqueue_ms"] = host
        opt = self.opt
        inner = opt.step

        def ranged(*a, **k):
            with torch.profiler.record_function(OPTIMIZER_RANGE):
                return inner(*a, **k)

        opt.step = ranged
        n = int(run.cell.traffic["trace_steps"])
        try:
            run.profile(self.call, n, n * self.batch)
        finally:
            del opt.step
        return n

    def release(self) -> None:
        del self.model, self.opt

    # -- the check -----------------------------------------------------------

    def program_readings(self) -> dict:
        """The program's losses, first gradient and change norms, the
        change against the seed's weights made again."""
        dev = self.run.device
        start = make_state(self.arch, self.run.seed, dev)
        params = self.readings["params"]
        change = {n: ((p.to(dev) - start[n]) * self.mask[n]).norm().item() for n, p in params.items()}
        return {"losses": self.readings["losses"], "grad_norms": self.readings["grad_norms"],
                "grads": self.readings["grads"], "change_norms": change}

    def reference_readings(self, numerics: str = "fp32", half_batch: bool = False, unchanged: bool = False) -> dict:
        """The reference's three steps on the same weights and batches.
        Planted faults: ``half_batch`` trains on the first half of each
        batch's rows, ``unchanged`` at lr 0 (a state left unchanged)."""
        dev = self.run.device
        P = make_state(self.arch, self.run.seed, dev)
        start = {n: t.clone() for n, t in P.items() if t.is_floating_point()}
        batches = []
        for b in self.pool[:CHECK_STEPS]:
            rb = reference_batch(b, dev)
            batches.append({k: v[: self.batch // 2] for k, v in rb.items()} if half_batch else rb)
        grads, first = {}, {}

        def on_grads(step, g):
            if step == 0:
                grads.update(_norms(g))
                first.update({n: t.detach().to("cpu", copy=True) for n, t in g.items()})
                if self.mask is None:
                    self.mask = _moving(g)

        optim = dict(self.prog_cfg["optim_wrapper"])
        keys = (optim.get("paramwise_cfg") or {}).get("custom_keys") or {}
        ref_optim = {"optimizer": dict(optim["optimizer"], lr=0.0) if unchanged else optim["optimizer"],
                     "custom_keys": {k: (v["lr_mult"] if isinstance(v, dict) else v) for k, v in keys.items()}}
        losses = train_steps(self.arch, ref_optim, self.prog_cfg["schedule"], P, batches, self.run.seed,
                             Numerics(numerics), on_grads)
        stats = ("running_mean", "running_var")
        change = {n: ((P[n] - t) * self.mask[n]).norm().item() for n, t in start.items() if not n.endswith(stats)}
        return {"losses": [x["loss"] for x in losses], "grad_norms": grads, "grads": first, "change_norms": change}

    def numbers(self, ref: dict, other: dict) -> Dict[str, float]:
        return compare.train_numbers(other, ref)

    def diagnostics(self, ref: dict, other: dict) -> dict:
        return compare.train_diagnostics(other, ref)

