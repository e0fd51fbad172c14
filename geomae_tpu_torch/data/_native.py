"""Build and bind the native point-prep core (``csrc/pointprep.cpp``).

The port's counterpart of ``geomae_tpu/csrc/__init__.py``.  The host C++
source compiles with ``g++ -O3 -march=native`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The library lands in
``build/geomae_tpu_torch/`` beside the CUDA kernels' (``ops/_cuda.py``),
named by a hash of the source and of the host's CPU, never next to the
source.  It is built
into a file of its own and renamed into place, so processes that build at
once (pytest-xdist workers) never load a half-written library.  A failed
build raises with the compiler's output: there is no numpy fallback here
(``data/native_prep.py``).  Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pointprep.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` code built on
    one host may not run on another that shares the build directory."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keys = (b"model name", b"flags")
    return b"\n".join(next((ln for ln in lines if ln.startswith(k)), b"")
                      for k in keys)


def library_path() -> Path:
    """The library's file, named by a hash of the source and the host
    CPU."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(_host_cpu())
    return BUILD_DIR / f"libpointprep_{h.hexdigest()[:16]}.so"


def build(out: Path, cxx: str = "g++") -> None:
    """Compile ``csrc/pointprep.cpp`` into ``out`` with ``cxx``; raises
    ``RuntimeError`` with the compiler's output when it fails or is
    missing."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, "-O3", "-march=native", "-shared", "-fPIC", str(SOURCE),
           "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {SOURCE.name}: no compiler "
                           f"{cxx!r} ({e})") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stderr}{res.stdout}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The point-prep library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.prep_sweep.restype = ctypes.c_int64
    lib.prep_sweep.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, f32p,
        f32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.shuffle_rows.restype = None
    lib.shuffle_rows.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_uint64]
    lib.build_scene.restype = ctypes.c_int64
    lib.build_scene.argtypes = (
        [f32p, ctypes.c_int64, ctypes.c_int32]
        + [ctypes.c_float] * 6
        + [ctypes.c_int32] * 8
        + [ctypes.c_int64, ctypes.c_int32]
        + [f32p, i32p, i32p, i32p, i32p, i32p, u8p])
    return lib


def f32_ptr(a: Optional[np.ndarray]):
    """A float pointer to ``a``'s data, or a null pointer for None."""
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def prep_sweep(pts: np.ndarray, out: np.ndarray, cursor: ctypes.c_int64,
               R: Optional[np.ndarray], t: Optional[np.ndarray],
               time_lag: float, remove_close_radius: float,
               rot: float, scale: float, flip_y: bool, flip_x: bool,
               pc_range: Optional[np.ndarray]) -> int:
    """One fused sweep-prep call: append ``pts`` (float32 [N, D], C
    order), transformed, augmented and range-filtered, to ``out`` [cap,
    D] at row ``cursor``, which advances; returns the rows written."""
    if pts.dtype != np.float32 or not pts.flags.c_contiguous \
            or pts.shape[1] != out.shape[1]:
        raise ValueError(f"prep_sweep: points {pts.dtype} {pts.shape} "
                         f"against an output of {out.shape}")
    return library().prep_sweep(
        f32_ptr(pts), pts.shape[0], pts.shape[1],
        f32_ptr(R), f32_ptr(t), time_lag, remove_close_radius,
        float(np.cos(rot)), float(np.sin(rot)), scale,
        int(flip_y), int(flip_x), f32_ptr(pc_range),
        f32_ptr(out), out.shape[0], ctypes.byref(cursor))
