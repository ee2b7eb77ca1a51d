"""The readings that a cell's limits are set from, many seeds in one
process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... --control-seeds 11,12,13 \
        [--seconds 3] [--out calibrate_<cell>.jsonl]

For each seed: the cell's set-up (train: the three checked steps; serve: a
window of ``--seconds`` at the cell's load), the program's state freed, the
numbers of the program against the float32 reference (the lower
readings). For each control seed also the numbers of the control, the
reference computed with fp8 products in the program's place (the upper
readings), and, in train mode, of two planted faults: the reference
trained on half of each batch's rows, and at lr 0 (a state left
unchanged). One JSON line each; nothing here decides
``correct``.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path = [str(HERE.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


def readings(cell, seed: int, seconds: float, control: bool, device, tf32) -> dict:
    import torch

    from benchmark.run import Run

    # the program runs with the settings it finds; the reference without TF32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    run = Run(cell, seed, seconds, False, device)
    driver = cell.driver()(run)
    driver.setup()
    if cell.mode == "serve":
        driver.window()
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = driver.reference_readings("fp32")
    prog = driver.program_readings()
    out = {"seed": seed, "program": driver.numbers(ref, prog), "reference_s": time.perf_counter() - t0,
           "program_why": driver.diagnostics(ref, prog)}
    if control:
        ctrl = driver.reference_readings("fp8")
        out["control_fp8"] = driver.numbers(ref, ctrl)
        out["control_why"] = driver.diagnostics(ref, ctrl)
        if cell.mode == "train":
            out["fault_half_batch"] = driver.numbers(ref, driver.reference_readings("fp32", half_batch=True))
            out["fault_unchanged"] = driver.numbers(ref, driver.reference_readings("fp32", unchanged=True))
    del driver, run, ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.Cell(HERE, harness.load_benchmark(HERE), args.workload)
    if device is None:
        device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds + sorted(controls - set(seeds)):
            line = json.dumps({"cell": cell.name,
                               **readings(cell, seed, args.seconds, seed in controls, device, tf32)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
