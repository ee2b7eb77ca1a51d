"""The served ``cod`` batch's time on the GPU: eager ``predict`` and the
same forward through a serving bundle (``tools/export_serving.py``), and
with ``--parent DIR`` another tree's eager ``predict``, in turns in one run.

Full-width ``cod`` (seeded weights), bf16 autocast, 384²: eager at batch 1
and batch 8 (``model.predict`` on tensors already on the card), the bundle
at batch 1 (its program's shape; the program on tensors on the card, and
``ServingModel.__call__`` with its host copies). Each leg runs in a
process of its own (a tree's package cannot be imported twice in one
process), in the order parent, this tree, bundle, bundle, this tree,
parent; a leg warms up every shape, then times ``--iters`` calls of each,
twice and in turns, by the host's clock ending in a synchronisation (the
path is host-bound) and by CUDA events.
``DIR`` is another checkout (e.g. a ``git archive`` of the parent commit);
this tree's built stencil libraries are copied into its build directory,
where it loads them if its sources hash alike, else builds its own.

    python -m dgtd_tpu_torch.tools.profile_serving [--parent DIR] [--iters 30] [--json OUT]

Prints one JSON object: the legs' ms a call, the bundle's export seconds
and size on disk, the stencil launches a bundle call made, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = 384
BATCHES = (1, 8)
WARMUP = 10  # calls of each shape before any is timed

# one leg in a fresh interpreter whose working directory is the tree to
# time; argv: leg ("eager" or "bundle"), iters, bundle dir
_LEG = r"""
import json, sys, time
import numpy as np
import torch
leg, iters, bundle = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dev = torch.device("cuda")


def timed(fn, iters):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"host_ms": (time.perf_counter() - t0) * 1e3 / iters, "event_ms": start.elapsed_time(end) / iters}


g = torch.Generator().manual_seed(0)
inputs = {b: (torch.randn(b, SIZE, SIZE, 3, generator=g).to(dev), torch.rand(b, SIZE, SIZE, 1, generator=g).to(dev))
          for b in BATCHES}
out = {}
if leg == "eager":
    from dgtd_tpu_torch.models.cod import cod

    model = cod(seed=0).to(dev)
    fns = {f"batch{b}": (lambda img=img, dep=dep: model.predict(img, dep)) for b, (img, dep) in inputs.items()}
else:
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.tools.export_serving import ServingModel

    serving = ServingModel.load(bundle)
    img, dep = inputs[1]
    before = D.FUSED_LAUNCHES
    serving.run(SIZE, img, dep)
    torch.cuda.synchronize()
    out["launches_a_call"] = D.FUSED_LAUNCHES - before
    img_np, dep_np = img.cpu().numpy(), dep.cpu().numpy()
    fns = {"batch1": lambda: serving.run(SIZE, img, dep), "batch1_numpy_in_out": lambda: serving(img_np, dep_np)}
for _ in range(WARMUP):
    for fn in fns.values():
        fn()
# two rounds, the functions in turns: a drift within the process shows
for name, fn in list(fns.items()) * 2:
    out.setdefault(name, []).append(timed(fn, iters))
print("LEG " + json.dumps(out))
""".replace("SIZE", str(SIZE)).replace("BATCHES", repr(BATCHES)).replace("WARMUP", str(WARMUP))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _copy_kernels(tree: str) -> None:
    """Give ``tree`` this tree's built stencil kernels: a library's name
    holds the hash of its sources, so ``tree`` loads one only where its
    own sources are the same."""
    from ..ops import _build

    dest = os.path.join(tree, "dgtd_tpu_torch", "_build")
    os.makedirs(dest, exist_ok=True)
    for path in _build.build(["diffusion_stencil", "diffusion_stencil_bwd"]).values():
        shutil.copy(path, os.path.join(dest, path.name))


def _leg(tree: str, leg: str, iters: int, bundle: str) -> dict:
    env = {**os.environ, "PYTHONPATH": tree}
    res = subprocess.run([sys.executable, "-c", _LEG, leg, str(iters), bundle], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"{leg} leg in {tree} failed:\n{res.stderr[-4000:]}")
    return json.loads(next(line[4:] for line in res.stdout.splitlines() if line.startswith("LEG ")))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="another checkout to time beside this tree")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    import torch

    from ..core.device import resolve_device
    from ..models.cod import cod
    from .export_serving import export_bundle

    resolve_device("cuda")
    result = {"card": _card(), "torch": torch.__version__, "size": SIZE, "iters": args.iters}
    with tempfile.TemporaryDirectory(prefix="profile_serving_") as tmp:
        bundle = os.path.join(tmp, "bundle")
        meta = export_bundle(cod(seed=0), bundle, sizes=[SIZE], meta_extra={"model": "cod"})
        torch.cuda.empty_cache()
        result["export_s"] = meta["export_seconds"]["cuda"][str(SIZE)]
        result["bundle_bytes"] = {f: os.path.getsize(os.path.join(bundle, f)) for f in sorted(os.listdir(bundle))}
        order = [("this", "eager"), ("bundle", "bundle"), ("bundle", "bundle"), ("this", "eager")]
        if args.parent:
            _copy_kernels(args.parent)
            order = [("parent", "eager")] + order + [("parent", "eager")]
        trees = {"this": ROOT, "bundle": ROOT, "parent": args.parent}
        legs = []
        for name, leg in order:
            t0 = time.perf_counter()
            legs.append({"tree": name, **_leg(trees[name], leg, args.iters, bundle),
                         "leg_s": time.perf_counter() - t0})
            print(json.dumps(legs[-1]), flush=True)
        result["legs"] = legs
    print(json.dumps({"profile_serving": result}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
