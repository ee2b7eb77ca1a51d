"""Run one cell of ``BENCHMARK.json`` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, in order: the weights and inputs from ``--seed``; the cell's
set-up and warm-up (``setup_s`` runs from the process's start to here);
the measured window of ``--seconds`` (``--trace 0``: the cell's end-to-end
metrics) or the traced steps (``--trace 1``: its per-layer metrics); the
peak memory read; the program's state freed; the reference run on what the
window produced, and every number compared printed beside its limit, last
on standard error and last in the result line, which is the last line of
standard output. Exits 2 without a result when there is no card, fewer
cards than the cell asks for, or a module of JAX or of the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if __name__ == "__main__":
    sys.path = [str(REPO)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


class Run:
    """One run: the cell, the seed, the device, and what the traced steps
    leave for the per-layer readers (``readings``, ``trace``)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace_on = cell, int(seed), float(seconds), bool(trace)
        self.device = device
        self.readings = {}
        self.trace = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profile(self, fn, units: int, images: int) -> None:
        """Profile ``units`` calls of ``fn`` (one warm-up call first, not
        recorded) into ``self.trace``; the window is the host clock from
        the first recorded call to the card synchronised after the last."""
        import torch

        from benchmark import yardstick

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=units, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            fn()
            self.sync()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(units):
                fn()
            self.sync()
            window = time.perf_counter() - t0
            prof.step()
        self.trace = yardstick.from_profiler(prof, window, units)
        self.readings["images"] = images


class HostLoad:
    """What the host did during a window besides dispatching the work: the
    process's CPU seconds and Python's collections, for a line on standard
    error beside the quartiles of the window's steps or batches."""

    def __enter__(self):
        self.gc_s, self.collections, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._on_gc)
        self.cpu0, self.wall0 = time.process_time(), time.perf_counter()
        return self

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1

    def __exit__(self, *exc):
        self.cpu_s = time.process_time() - self.cpu0
        self.wall_s = time.perf_counter() - self.wall0
        gc.callbacks.remove(self._on_gc)

    def line(self, unit_s) -> str:
        q = statistics.quantiles(unit_s, n=4) if len(unit_s) > 1 else list(unit_s) * 3
        return (f"window: {len(unit_s)} units, ms quartiles {[x * 1e3 for x in q]!r}, max "
                f"{max(unit_s, default=0.0) * 1e3!r}; process CPU {self.cpu_s!r} s over {self.wall_s!r} s; "
                f"gc {self.collections} collections by generation, {self.gc_s!r} s; "
                f"{len(os.sched_getaffinity(0))} CPUs, {threading.active_count()} Python threads")


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def refused(when: str) -> bool:
    """Whether a module of JAX or of the JAX package is loaded, said on
    standard error."""
    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        print(f"refused: loaded {when}: {found}", file=sys.stderr)
    return bool(found)


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, root: Path = HERE, t_start: float = T_START) -> int:
    """Run a cell; returns the exit code. ``device`` is for the tests: they
    pass the CPU and skip the look for a card."""
    args = parse(argv)
    from benchmark import harness

    if refused("before the run"):
        return 2
    import torch

    cell = harness.Cell(root, harness.load_benchmark(root), args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"refused: cell {cell.name} needs {cell.chips} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        # the work is the card's: the host's threads only dispatch
        torch.set_num_threads(1)
    run = Run(cell, args.seed, args.seconds, args.trace, device)
    driver = cell.driver()(run)
    driver.setup()
    # what set-up built lives through the run: no collection scans it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    metrics, breakdown = {}, None
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    if not run.trace_on:
        with HostLoad() as load:
            attempted, failed, values = driver.window()
        retries = torch.cuda.memory_stats(device).get("num_alloc_retries") if device.type == "cuda" else 0
        print(f"{load.line(run.readings.get('unit_s', []))}; allocator retries {retries}", file=sys.stderr)
        values["setup_s"] = setup_s
        if device.type == "cuda":
            values["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        for m in cell.metrics("end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    else:
        attempted, failed = driver.traced(), 0
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        if run.trace is not None:
            breakdown = run.trace.breakdown()
            for cat, secs in run.trace.by_category().items():
                print(f"device {cat}: {secs * 1e3 / run.trace.units!r} ms a step", file=sys.stderr)
    dev = device_info(device)
    if run.trace_on and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s

    gc.unfreeze()
    if refused("during the run"):
        return 2

    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    from benchmark import compare

    numbers = driver.numbers(driver.reference_readings(), driver.program_readings())
    checks = compare.judge(numbers, cell.limits)
    ok = compare.correct(checks)
    print(f"cell {cell.name} seed {args.seed} trace {args.trace}: card {power_limit() if device.type == 'cuda' else 'cpu'}; "
          f"setup_s {setup_s:.3f}; reference check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    for name in sorted(set(numbers) - set(checks)):
        print(f"reading {name} {numbers[name]!r} (not compared: it has no upper reading)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if refused("by the reference check"):
        return 2
    print(harness.result_line(ok, attempted, failed, metrics, dev, checks, breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(REPO / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / ".bench_cache" / "triton"))
    sys.exit(main())
