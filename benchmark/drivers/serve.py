"""Serve mode: served batches of the port, closed loop, one batch in
flight, as ``predict.py`` runs them.

A batch's latency runs from handing its pinned uint8 host tensors to the
port until its fp32 map is on the host (``program.serve_call``, then the
copy's event waited on). Set-up serves ``warmup`` batches. The window
serves the pool's batches in turn for ``--seconds``:
``serve_images_per_s`` is every image served over all its time,
``serve_p95_ms`` the 95th percentile of every batch's latency. A sample of
``check_batches`` of the served batches, drawn from the seed by reservoir
sampling, is kept and held to the reference once the window has closed.

Traffic keys, all required: ``batch``, ``size``, ``pool``, ``warmup``,
``check_batches``, ``trace_batches``, ``enqueue_reps``.
"""

from __future__ import annotations

import random
import statistics
import time
from typing import Dict, List

import torch

from benchmark import compare, program
from benchmark.inputs import make_pool, reference_batch
from benchmark.reference.models import probability
from benchmark.reference.numerics import Numerics
from benchmark.weights import make_state

#: rows of a reference forward at a time
REFERENCE_ROWS = 8
#: label of the range opened around the prompt encoder in a traced run
PROMPT_ENCODER_RANGE = "bench.prompt_encoder"


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.cell.traffic
        self.batch, self.size, self.pool_size = int(t["batch"]), int(t["size"]), int(t["pool"])
        self.keep = int(t["check_batches"])
        self.arch = run.cell.config["architecture"]
        self.prog_cfg = run.cell.config["program"]
        self.served = 0
        self.sample: List[tuple] = []
        self.rng = random.Random(f"{run.seed}:sample")

    def setup(self) -> None:
        run = self.run
        dev = run.device
        state = make_state(self.arch, run.seed, dev)
        self.model = program.build_model(self.prog_cfg, state, dev)
        del state
        self.pool = make_pool(run.seed, self.pool_size, self.batch, self.size, labels=False, pin=dev.type == "cuda")
        for i in range(int(run.cell.traffic["warmup"])):
            _, done = program.serve_call(self.model, self.pool[i % self.pool_size], dev)
            if done is not None:
                done.synchronize()
        run.sync()

    def call(self) -> float:
        """Serve the next batch; its latency in seconds. The batch joins the
        seeded reservoir sample of served batches."""
        i = self.served % self.pool_size
        t0 = time.perf_counter()
        host, done = program.serve_call(self.model, self.pool[i], self.run.device)
        if done is not None:
            done.synchronize()
        lat = time.perf_counter() - t0
        self.served += 1
        if len(self.sample) < self.keep:
            self.sample.append((i, host))
        else:
            j = self.rng.randrange(self.served)
            if j < self.keep:
                self.sample[j] = (i, host)
        return lat

    def window(self):
        run = self.run
        run.sync()
        lats = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            lats.append(self.call())
        elapsed = time.perf_counter() - t0
        run.readings["unit_s"] = lats
        p95 = statistics.quantiles(lats, n=20, method="inclusive")[-1] if len(lats) > 1 else lats[0]
        return len(lats), 0, {"serve_images_per_s": len(lats) * self.batch / elapsed, "serve_p95_ms": p95 * 1e3}

    def traced(self) -> int:
        run = self.run
        dev = run.device
        host = []
        for k in range(int(run.cell.traffic["enqueue_reps"])):
            run.sync()
            t0 = time.perf_counter()
            _, done = program.serve_call(self.model, self.pool[k % self.pool_size], dev)
            host.append((time.perf_counter() - t0) * 1e3)
            if done is not None:
                done.synchronize()
        run.readings["serve_enqueue_ms"] = host
        hooks = []
        enc = program.prompt_encoder(self.model)
        if enc is not None:
            ranges = []

            def opened(mod, args):
                rf = torch.profiler.record_function(PROMPT_ENCODER_RANGE)
                rf.__enter__()
                ranges.append(rf)

            def closed(mod, args, out):
                ranges.pop().__exit__(None, None, None)

            hooks = [enc.register_forward_pre_hook(opened), enc.register_forward_hook(closed)]
        n = int(run.cell.traffic["trace_batches"])
        try:
            run.profile(self.call, n, n * self.batch)
        finally:
            for h in hooks:
                h.remove()
        return n

    def release(self) -> None:
        del self.model

    # -- the check -----------------------------------------------------------

    def program_readings(self) -> list:
        return [host for _, host in self.sample]

    def reference_readings(self, numerics: str = "fp32") -> list:
        """The reference's maps of the sampled batches, NHWC on the host,
        computed ``REFERENCE_ROWS`` images at a time."""
        dev = self.run.device
        P = make_state(self.arch, self.run.seed, dev)
        nx = Numerics(numerics)
        out = []
        with torch.no_grad():
            for i, _ in self.sample:
                rb = reference_batch(self.pool[i], dev)
                rows = [probability(self.arch, P, rb["input"][a:a + REFERENCE_ROWS],
                                    rb["depth"][a:a + REFERENCE_ROWS], nx).permute(0, 2, 3, 1).cpu()
                        for a in range(0, self.batch, REFERENCE_ROWS)]
                out.append(torch.cat(rows))
        return out

    def numbers(self, ref: list, other: list) -> Dict[str, float]:
        return compare.serve_numbers(other, ref)

    def diagnostics(self, ref: list, other: list) -> dict:
        return compare.serve_diagnostics(other, ref)
