"""What a run finds by name, and what it prints.

Everything that belongs to one configuration, traffic mix, driver mode or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model as the program builds it
  (``program``), its architecture as the reference computes it
  (``architecture``), its source, ``reduced``, ``assumed``, and its FLOPs
  an image;
* ``traffic/<traffic>.json``: ``mode`` and its parameters (batch, size,
  pool, ...);
* ``drivers/<mode>.py``: the driver of a mode (a class ``Driver``);
* ``metrics/<metric>.py``: the reader of a per-layer metric (a function
  ``read(run)`` that returns a number, or None where it finds nothing);
* ``limits/<workload>.json``: the limit of each number compared, with the
  readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

#: modules that no run may load, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "dgtd_tpu")


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN (the
    part before the first dot, compared whole: ``dgtd_tpu_torch`` passes)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_benchmark(root: Path) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def read_json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    return json.loads(path.read_text())


def load_module(root: Path, kind: str, name: str):
    """The module ``<root>/<kind>/<name>.py``, loaded from its file (names
    may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, root: Path, bench: dict, name: str):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")
        self.root = root
        self.bench = bench
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = read_json(root, "configs", self.workload["config"])
        self.traffic = read_json(root, "traffic", self.workload["traffic"])
        self.mode = self.traffic["mode"]
        limits = root / "limits" / f"{name}.json"
        self.limits: Dict[str, dict] = json.loads(limits.read_text()) if limits.is_file() else {}

    def metrics(self, section: str) -> List[dict]:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        this cell reports: those that list it, and the end-to-end metrics
        that list no cells. Every per-layer metric lists its cells."""
        if section == "end_to_end":
            return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]

    def driver(self):
        return load_module(self.root, "drivers", self.mode).Driver

    def reader(self, metric: str):
        return load_module(self.root, "metrics", metric).read


def plain(x):
    """A number for the result line: non-finite values as strings."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; the numbers compared come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": plain(c["value"]), "limit": c["limit"]} for n, c in checks.items()}
    return json.dumps(out)
