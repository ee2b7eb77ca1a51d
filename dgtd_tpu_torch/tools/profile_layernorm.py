"""The LayerNorm kernel's time on the GPU, L2-warm and L2-cold, beside
``F.layer_norm`` and, optionally, another tree's kernel in the same process.

At a PVTv2-b2 and a ConvNeXt-B stage-1 shape of a served batch ((73728, 64)
and (73728, 128), bf16) it times one launch of the kernel into a
preallocated output:
  * L2-warm: the same input and output back to back (both fit in the 50 MB
    L2, so the input may come from L2 and a call can beat the HBM bound);
  * L2-cold: 8 input/output pairs in turn (151 MB and 302 MB), so that every
    call reads its input from HBM;
each by CUDA events over the calls and by ``torch.profiler``'s device time a
launch, beside the bound (bytes over 3.35 TB/s), ``F.layer_norm`` timed
both ways and ``torch.neg`` of x into the output over the same rotation
(one elementwise kernel moving the same bytes, no reduction). With ``--parent DIR`` it
also builds ``DIR/dgtd_tpu_torch/csrc/layernorm.cu`` (another checkout,
e.g. a ``git archive`` of the parent commit; the same C interface) and
times the two kernels in turns: parent, change, change, parent.

    python -m dgtd_tpu_torch.tools.profile_layernorm [--parent DIR] [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import tempfile

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ..ops import _build
from ..ops import layernorm as L

SHAPES = {"pvt_b2_stage1": (8 * 96 * 96, 64), "convnext_b_stage1": (8 * 96 * 96, 128)}
ROTATION = 8
HBM_BYTES_PER_S = 3.35e12
TORCH_LN_KERNELS = ("layer_norm", "LayerNorm", "RowwiseMoments")
ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def build_other(root: str, out_dir: str):
    """``dgtd_layer_norm`` of another checkout's source, built with this
    tree's flags."""
    lib = os.path.join(out_dir, "liblayernorm_other.so")
    src = os.path.join(root, "dgtd_tpu_torch", "csrc", "layernorm.cu")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib).dgtd_layer_norm
    fn.argtypes, fn.restype = ARGS, ctypes.c_int
    return fn


def events_ms(fn, iters: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, names) -> float:
    """Device ms a launch of the kernels whose name holds one of ``names``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if not e.key.startswith("aten::") and any(n in e.key for n in names)]
    launches = sum(e.count for e in found)
    return sum(e.device_time_total for e in found) / 1e3 / launches if launches else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="another checkout whose layernorm.cu is timed beside this one")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_layernorm needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kernels = {"change": L._fn()}
    with tempfile.TemporaryDirectory(prefix="profile_layernorm_") as tmp:
        if args.parent:
            kernels["parent"] = build_other(args.parent, tmp)
        order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
        g = torch.Generator(device=dev).manual_seed(0)
        for name, (rows, c) in SHAPES.items():
            xs = [(torch.randn(rows, c, generator=g, device=dev) * 3 + 1).bfloat16() for _ in range(ROTATION)]
            outs = [torch.empty_like(x) for x in xs]
            sc = torch.randn(c, generator=g, device=dev).bfloat16().float()
            bi = torch.randn(c, generator=g, device=dev).bfloat16().float()
            sl, bl = sc.bfloat16(), bi.bfloat16()
            stream = torch.cuda.current_stream().cuda_stream
            ref = L.layer_norm_plain(xs[0], sc, bi, 1e-6).float()
            bound = (2 * xs[0].numel() * 2 + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
            row = {"shape": [rows, c], "dtype": "bfloat16", "bound_ms": bound, "route": L.ln_route(
                c, torch.bfloat16, xs[0].data_ptr(), outs[0].data_ptr()), "card": card}

            def call(fn, i):
                rc = fn(xs[i].data_ptr(), sc.data_ptr(), bi.data_ptr(), outs[i].data_ptr(), rows, c, 1e-6, 1, 0,
                        stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            for who, fn in kernels.items():
                call(fn, 0)
                torch.cuda.synchronize()
                row[f"{who}_max_abs_err"] = float((outs[0].float() - ref).abs().max())
            for turn, who in enumerate(order):
                fn = kernels[who]
                cycle = itertools.cycle(range(ROTATION))
                warm = lambda: call(fn, 0)
                cold = lambda: call(fn, next(cycle))
                row[f"{who}_{turn}"] = {
                    "warm_ms": events_ms(warm, args.iters), "cold_ms": events_ms(cold, args.iters),
                    "warm_device_ms": device_ms(warm, args.iters, ("ln_",)),
                    "cold_device_ms": device_ms(cold, args.iters, ("ln_",))}
            cycle = itertools.cycle(range(ROTATION))
            lib_warm = lambda: F.layer_norm(xs[0], (c,), sl, bl, 1e-6)
            lib_cold = lambda: F.layer_norm(xs[next(cycle)], (c,), sl, bl, 1e-6)
            row["F.layer_norm"] = {
                "warm_ms": events_ms(lib_warm, args.iters), "cold_ms": events_ms(lib_cold, args.iters),
                "warm_device_ms": device_ms(lib_warm, args.iters, TORCH_LN_KERNELS),
                "cold_device_ms": device_ms(lib_cold, args.iters, TORCH_LN_KERNELS)}
            # the same bytes through one elementwise PyTorch kernel (x read
            # once, out written once, no reduction): a floor for this traffic
            cycle = itertools.cycle(range(ROTATION))
            neg_cold = lambda: (lambda i: torch.neg(xs[i], out=outs[i]))(next(cycle))
            row["elementwise"] = {"cold_device_ms": device_ms(neg_cold, args.iters, ("elementwise",)),
                                  "cold_ms": events_ms(neg_cold, args.iters)}
            print(json.dumps({"layernorm": {name: row}}), flush=True)
            del xs, outs


if __name__ == "__main__":
    main()
