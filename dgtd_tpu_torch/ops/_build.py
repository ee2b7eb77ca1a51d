"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``dgtd_tpu_torch/_build/lib<name>-<hash>.so`` (the hash is of the source and
of the shared ``csrc/*.cuh`` headers, so an edited source rebuilds), then
loaded with ``ctypes``. Nothing is built when
a module is imported: the CPU path never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: the dtype code every C interface takes: 0 = float32, 1 = bfloat16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s output (ptxas register/spill report) per built source
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    # the hash covers the shared headers too, so an edited header rebuilds
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, all ``nvcc``
    processes started together. Returns name -> library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


_FNS: Dict[str, Callable] = {}


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int) -> Callable:
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types set; it returns a ``cudaError_t`` as an int unless ``restype``
    says otherwise."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[symbol] = fn
    return fn


def device_and_stream(t) -> Tuple[int, int]:
    """The CUDA ordinal of ``t`` and the handle of its current stream, as
    the C functions take them. The raw handle, not ``torch.cuda.current_stream``,
    which builds a Python ``Stream`` object on every call: this runs once per
    launch, and small launches are bound by their host time."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)
