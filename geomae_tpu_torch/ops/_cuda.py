"""Build and load the port's CUDA kernels.

All of ``geomae_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/geomae_tpu_torch/`` at the repository root,
named by a hash of the sources, so an edited source builds anew and an
unchanged one loads the library already there.  Nothing here runs at
import time: the first wrapper that launches a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "geomae_tpu_torch"
ARCH = "arch=compute_90a,code=sm_90a"

# dtype codes of csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "geomae_segment_work_bytes": [_I, _I, _I],
    "geomae_segment_reduce": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "geomae_segment_broadcast": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "geomae_segment_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    # K6 / K7: (B, V, C, H); the projections: (B, V, C)
    "geomae_band_attention_qkv": [_I] + [_P] * 12 + [_I] * 4 + [_P],
    "geomae_band_attention_qkv_bwd": [_I] + [_P] * 19 + [_I] * 5 + [_P],
    "geomae_qkv_project": [_P] * 12 + [_I] * 3 + [_P],
    "geomae_qkv_project_bwd": [_P] * 11 + [_I] * 5 + [_P],
    # K8: (B, V, H, D); K5: (B, V, C, F)
    "geomae_band_attention": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "geomae_band_attention_delta": [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "geomae_band_attention_bwd": [_I] + [_P] * 11 + [_I] * 4 + [_P],
    "geomae_post_attention_block": [_I] + [_P] * 14 + [_I] * 4 + [_F, _P],
    "geomae_post_attention_block_bwd": [_I] + [_P] * 21
    + [_I] * 4 + [_F, _I, _P],
    "geomae_post_attention_block_bwd_bf16": [_P] * 23 + [_I] * 4
    + [_F, _I, _P],
    "geomae_post_attention_wgrad_bf16": [_P] * 9 + [_I] * 4 + [_P],
    "geomae_slot_outer_segment_sum": [_P] * 4 + [_I] * 4 + [_P],
    "geomae_expand_rows": [_P] * 3 + [_I] * 4 + [_P],
}

# entry points that return something other than a CUDA error code
RESTYPES = {"geomae_segment_work_bytes": ctypes.c_longlong}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then the toolkit PyTorch
    found, then ``PATH``.  Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: geomae_tpu_torch builds its CUDA kernels from "
            "csrc/ with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgeomae_kernels_{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """Compile every ``csrc/*.cu`` into ``out``, the sources in parallel
    (``--threads 0``: one compilation per source, as many at once as the
    host has cores); ptxas's resource report (registers, shared memory,
    spills) goes to ``out`` + ``.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "--threads", "0", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{out}.log").write_text(" ".join(cmd) + "\n" + res.stdout
                                  + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        lib.geomae_error_string.argtypes = [ctypes.c_int]
        lib.geomae_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error (a refused launch
    never runs, and no later synchronize reports it)."""
    if code != 0:
        msg = library().geomae_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def persistent_blocks(t: torch.Tensor, per_sm: int, tiles: int) -> int:
    """Blocks of a persistent grid on ``t``'s device: ``per_sm`` on each
    SM (what the kernel's shared memory lets reside), at most ``tiles``."""
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return max(1, min(tiles, sms * per_sm))


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev,
                f"{name}: tensors on {dev} and {t.device}")
        require(t.is_contiguous(), f"{name}: non-contiguous input")
