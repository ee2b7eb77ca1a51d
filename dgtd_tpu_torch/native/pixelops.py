"""The fused host pixel pipeline (``pixelops.cpp``): half-pixel bilinear
resize, normalize and horizontal flip of a decoded uint8 HWC image, bound
with ``ctypes``. Counterpart of ``dgtd_tpu/native/pixelops.py``, built from
the port's own copy of the source.

The library is built at first use with ``g++ -O3 -shared -fPIC`` into
``dgtd_tpu_torch/_build/libpixelops-<hash>.so`` (the hash is of the source,
so an edited source rebuilds). It is written under a temporary name and
renamed into place under a lock, so that threads, or processes collecting
tests at once, never load a half-written file. A build that fails raises:
``pipeline: native`` never falls back to other pixels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "pixelops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)


def lib_path() -> Path:
    return BUILD_DIR / f"libpixelops-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"


def build() -> Path:
    """The library for the current source, compiled if it is not there yet:
    one compile at a time (a thread lock and, across processes, a lock file
    beside the library), into a temporary name renamed into place. Raises
    ``RuntimeError`` when the compiler is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _BUILD_LOCK, open(BUILD_DIR / "pixelops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"pipeline: native needs g++ to build {SRC.name}: {e}") from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SRC.name} failed (g++ exited {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.resize_bilinear_normalize.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int, ctypes.c_int, _F32P, _F32P,
                ctypes.c_int]
            lib.resize_bilinear_normalize.restype = None
            lib.resize_bilinear_u8.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.resize_bilinear_u8.restype = None
            _LIB = lib
        return _LIB


def _hwc(src_u8: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src_u8, np.uint8)
    return src[:, :, None] if src.ndim == 2 else src


def resize_normalize(src_u8: np.ndarray, out_hw, mean: Optional[np.ndarray] = None,
                     std: Optional[np.ndarray] = None, flip: bool = False) -> np.ndarray:
    """uint8 HW or HWC -> float32 HWC: the half-pixel bilinear resize to
    ``out_hw``, ``(x/255 - mean)/std`` (mean 0 and std 1 when not given) and,
    with ``flip``, the horizontal mirror, in one pass."""
    lib = load()
    src = _hwc(src_u8)
    sh, sw, c = src.shape
    dh, dw = int(out_hw[0]), int(out_hw[1])
    mean = np.zeros(c, np.float32) if mean is None else np.ascontiguousarray(mean, np.float32)
    std = np.ones(c, np.float32) if std is None else np.ascontiguousarray(std, np.float32)
    dst = np.empty((dh, dw, c), np.float32)
    lib.resize_bilinear_normalize(src.ctypes.data_as(_U8P), sh, sw, c, dst.ctypes.data_as(_F32P), dh, dw,
                                  mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P), int(bool(flip)))
    return dst


def resize_u8(src_u8: np.ndarray, out_hw, flip: bool = False) -> np.ndarray:
    """uint8 HW or HWC -> uint8 HWC: the same resize (and flip), rounded to
    the nearest integer, not normalized (``uint8_io``: normalized on the
    device)."""
    lib = load()
    src = _hwc(src_u8)
    sh, sw, c = src.shape
    dh, dw = int(out_hw[0]), int(out_hw[1])
    dst = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(src.ctypes.data_as(_U8P), sh, sw, c, dst.ctypes.data_as(_U8P), dh, dw, int(bool(flip)))
    return dst
