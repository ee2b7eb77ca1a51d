"""Depth mode: the offline depther's batches, closed loop, one batch in
flight, as ``depth_gen --estimator dinov2 --batch N`` runs them over a
folder of photos of one size.

The port's depther (``tools/depth_gen.py::Dinov2Depther``) is built from
the configuration's ``DinoDPTDepther`` on the meta device, then empty on
the card, then ``load_state_dict`` of the reference's seeded state
(``reference/depther.py::make_state``). A batch's latency runs from
handing its pinned uint8 (B, H, W, 3) images to ``Dinov2Depther.batch``
until its fp32 (B, H, W) depth maps are on the host. Set-up runs
``warmup`` batches; the window runs the pool's batches in turn for
``--seconds``: ``serve_images_per_s`` is every image over all its time,
``serve_p95_ms`` the 95th percentile of every batch's latency. A sample of
``check_batches`` batches, drawn from the seed by reservoir sampling over
every batch run (the warm-up's too, so that a set-up alone leaves one), is
kept and held to the reference once the window has closed.

The compared numbers, per image scaled by the reference map's range
(max − min): ``depth_max_gap``, the largest |d − d_ref|, and
``depth_mean_gap``, the mean of the same.

Traffic keys, all required: ``batch``, ``size`` ("<H>x<W>"), ``pool``,
``warmup``, ``check_batches``, ``trace_batches``.
"""

from __future__ import annotations

import math
import random
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import depther as reference
from benchmark.reference.numerics import Numerics

#: images of a reference forward at a time
REFERENCE_ROWS = 4


def image_size(traffic: dict):
    h, w = (int(v) for v in str(traffic["size"]).split("x"))
    return h, w


def make_images(seed: int, batches: int, batch: int, h: int, w: int, pin: bool) -> List[torch.Tensor]:
    """``batches`` uint8 RGB (B, H, W, 3) batches: smooth random colour
    fields (noise at 1/16 of the size, resized bilinearly) with pixel noise
    on top, as ``benchmark/inputs.py`` makes its images; pinned when
    ``pin``."""
    words = np.random.SeedSequence([int(seed), 2]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed((int(words[0]) << 32) | int(words[1]))
    n = batches * batch
    low = torch.rand(n, 3, max(h // 16, 1), max(w // 16, 1), generator=gen)
    smooth = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    image = 0.75 * smooth + 0.25 * torch.rand(n, 3, h, w, generator=gen)
    u8 = (image.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    out = [u8[i * batch:(i + 1) * batch].clone() for i in range(batches)]
    return [b.pin_memory() for b in out] if pin else out


def build_depther(program: dict, state: Dict[str, torch.Tensor], device: torch.device):
    """The port's ``Dinov2Depther`` of the configuration holding ``state``."""
    from dgtd_tpu_torch.models.dpt import DinoDPTDepther
    from dgtd_tpu_torch.tools.depth_gen import Dinov2Depther

    with torch.device("meta"):
        model = DinoDPTDepther(**program["model"], dtype=getattr(torch, program["dtype"]))
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return Dinov2Depther(model, device)


def depth_numbers(prog: List, ref: List) -> Dict[str, float]:
    """``depth_max_gap`` and ``depth_mean_gap`` of matching lists of
    (B, H, W) depth batches."""
    worst, total, count = 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return {"depth_max_gap": math.inf, "depth_mean_gap": math.inf}
        r = r.float()
        span = (r.amax(dim=(1, 2)) - r.amin(dim=(1, 2))).clamp_min(1e-30)[:, None, None]
        d = (p.float() - r).abs() / span
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        count += d.numel()
    if len(prog) != len(ref) or count == 0 or not math.isfinite(total):
        return {"depth_max_gap": math.inf, "depth_mean_gap": math.inf}
    return {"depth_max_gap": worst, "depth_mean_gap": total / count}


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.cell.traffic
        self.batch, self.pool_size = int(t["batch"]), int(t["pool"])
        self.h, self.w = image_size(t)
        self.keep = int(t["check_batches"])
        self.arch = run.cell.config["architecture"]
        self.prog_cfg = run.cell.config["program"]
        self.done = 0
        self.sample: List[tuple] = []
        self.rng = random.Random(f"{run.seed}:sample")

    def setup(self) -> None:
        run = self.run
        dev = run.device
        state = reference.make_state(self.arch, run.seed, dev)
        self.depther = build_depther(self.prog_cfg, state, dev)
        del state
        self.pool = make_images(run.seed, self.pool_size, self.batch, self.h, self.w, pin=dev.type == "cuda")
        for _ in range(int(run.cell.traffic["warmup"])):
            self.call()
        run.sync()

    def call(self) -> float:
        """Run the next batch; its latency in seconds. The batch joins the
        seeded reservoir sample."""
        i = self.done % self.pool_size
        t0 = time.perf_counter()
        host = self.depther.batch(self.pool[i]).to("cpu", non_blocking=True)
        if self.run.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        lat = time.perf_counter() - t0
        self.done += 1
        if len(self.sample) < self.keep:
            self.sample.append((i, host))
        else:
            j = self.rng.randrange(self.done)
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
        n = int(self.run.cell.traffic["trace_batches"])
        self.run.profile(self.call, n, n * self.batch)
        return n

    def release(self) -> None:
        del self.depther

    # -- the check -----------------------------------------------------------

    def program_readings(self) -> list:
        return [host for _, host in self.sample]

    def reference_readings(self, numerics: str = "fp32") -> list:
        """The reference's maps of the sampled batches on the host,
        computed ``REFERENCE_ROWS`` images at a time on the run's device;
        each map's spread said on standard error."""
        dev = self.run.device
        P = reference.make_state(self.arch, self.run.seed, dev)
        nx = Numerics(numerics)
        out = []
        with torch.no_grad():
            for i, _ in self.sample:
                images = self.pool[i].to(dev)
                out.append(torch.cat([reference.forward(self.arch, P, images[a:a + REFERENCE_ROWS], nx).cpu()
                                      for a in range(0, self.batch, REFERENCE_ROWS)]))
        if numerics == "fp32" and out:
            maps = torch.cat(out)
            std = maps.flatten(1).std(dim=1)
            span = maps.amax(dim=(1, 2)) - maps.amin(dim=(1, 2))
            print(f"reference depth maps: {len(maps)} images, std {float(std.min())!r}..{float(std.max())!r}, "
                  f"range {float(span.min())!r}..{float(span.max())!r}, mean {float(maps.mean())!r}",
                  file=sys.stderr)
        return out

    def numbers(self, ref: list, other: list) -> Dict[str, float]:
        return depth_numbers(other, ref)

    def diagnostics(self, ref: list, other: list) -> dict:
        r = torch.cat([x.float() for x in ref])
        o = torch.cat([x.float() for x in other])
        d = (o - r).abs()
        return {"ref_std_min": float(r.flatten(1).std(dim=1).min()),
                "ref_range_min": float((r.amax(dim=(1, 2)) - r.amin(dim=(1, 2))).min()),
                "abs_max_gap_m": float(d.max()), "abs_mean_gap_m": float(d.mean())}
