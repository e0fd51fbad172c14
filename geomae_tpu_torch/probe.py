"""Timing on the card, and builds of a kernel source with parts swapped
out: what ``chip_smoke.py`` and the kernel probes (``probe_k4``,
``probe_k5_backward``, ``probe_k8_backward``) share.

``cuda_ms`` times a call with CUDA events.  ``build_variants`` compiles
one ``csrc/`` source (or the sources that include one header) once per
variant (a list of text edits), in parallel, ptxas's resource report
beside each build (``resources`` reads a kernel's), and ``time_variants``
times a set of calls on each build, every build twice, in turns.  A build with a part swapped out computes garbage;
only its time means something.  ``compare_sass`` holds kernels of this
package's build to a parent checkout's (``parent_and_change``).

Needs a CUDA GPU and ``nvcc``: its numbers are the card's.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

from .ops import _cuda

# the device spin cuda_ms enqueues its calls behind: about 5 ms at the
# H100's 1.98 GHz boost clock, longer than the host takes to enqueue 20
# calls of a wrapper
SPIN_CYCLES = 10_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3, spin: bool = True) -> float:
    """Mean time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.  With ``spin`` the calls are
    enqueued while the device spins (``torch.cuda._sleep``), so a call
    shorter than the host's cost of enqueuing it (a wrapper's checks, its
    allocation, the ctypes call: tens of microseconds) is timed on the
    device; without it, or for a call that waits for the device on the
    host (the plain versions), the time is the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_variants(source: str, variants: dict, out: Path,
                   units: tuple = ()) -> dict:
    """{name: loaded library} of ``csrc/<source>`` (with ``segment.cu``,
    which holds the error strings, where it is another source) built
    under ``out/<name>`` once per variant, each a list of (old, new) text
    edits; the builds run in parallel.  ``source`` may be a header; the
    sources in ``units`` (default: ``source``) are the ones compiled, each
    beside the variant's copy of every header.  Raises when an edit no
    longer applies or nvcc fails."""
    src = (_cuda.CSRC / source).read_text()
    units = units or (source,)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {source} no longer holds "
                                   f"{old.strip()!r}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in (*_cuda.CSRC.glob("*.cuh"), *(_cuda.CSRC / u for u in units)):
            (d / f.name).write_text(f.read_text())
        (d / source).write_text(text)
        errors = [] if "segment.cu" in units else [
            str(_cuda.CSRC / "segment.cu")]
        cmd = [_cuda.nvcc(), "-gencode", _cuda.ARCH, "-std=c++17", "-O3",
               "-shared", "--threads", "0", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o",
               str(d / "lib.so"), *[str(d / u) for u in units], *errors]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        Path(f"{path}.log").write_text(log)
        libs[name] = _load(path)
    return libs


def resources(lib: ctypes.CDLL, kernel: str) -> str:
    """Registers and spill bytes ptxas reported for the first kernel of
    the build behind ``lib`` whose mangled name holds ``kernel``."""
    log = Path(f"{lib._name}.log").read_text()
    i = log.find(kernel)
    regs = re.search(r"Used (\d+) registers", log[i:])
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      log[i:])
    return (f"{regs.group(1)} registers, {spill.group(1)} / "
            f"{spill.group(2)} bytes spilled")


def _load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the signatures of the entry points it
    holds (a build of some sources holds those of these sources only)."""
    lib = ctypes.CDLL(str(path))
    for fn, args in _cuda._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _cuda.RESTYPES.get(fn, ctypes.c_int)
    lib.geomae_error_string.argtypes = [ctypes.c_int]
    lib.geomae_error_string.restype = ctypes.c_char_p
    return lib


def parent_and_change(parent: Path) -> dict:
    """{"parent": the kernels' library of the checkout at ``parent``,
    built there (``build/geomae_tpu_torch/libgeomae_kernels_*.so``),
    "change": this package's, built now if it is not yet}."""
    libs = {"parent": sorted((parent / "build" / "geomae_tpu_torch").glob(
                "libgeomae_kernels_*.so"))[-1],
            "change": _cuda.library_path()}
    _cuda.library()
    print({k: str(v) for k, v in libs.items()})
    return libs


def sass(lib: Path, keep: re.Pattern) -> dict:
    """{demangled name: its SASS lines, addresses dropped} of the kernels
    in the library at ``lib`` whose demangled name (the anonymous
    namespace and the arguments dropped) ``keep`` finds."""
    tool = str(Path(_cuda.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            funcs[name].append(re.sub(r"/\*[0-9a-fx ]*\*/", "", line).strip())
    names = list(funcs)
    dem = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
    kept = {}
    for n, d in zip(names, dem):
        head = d.replace("(anonymous namespace)::", "").split("(")[0]
        if keep.search(head):
            kept[head] = funcs[n]
    return kept


def compare_sass(libs: dict, keep: re.Pattern, what: str) -> list:
    """Print how many of the kernels ``keep`` finds (``sass``) compile to
    the same SASS in ``libs["parent"]`` and ``libs["change"]``, and name
    those that differ; returns their names."""
    a, b = (sass(libs[k], keep) for k in ("parent", "change"))
    same = [k for k in a if a[k] == b.get(k)]
    print(f"SASS of {what}: {len(a)} in the parent, {len(b)} in the change, "
          f"{len(same)} the same")
    differ = sorted((set(a) | set(b)) - set(same))
    for k in differ:
        print(f"  DIFFERS ({len(a.get(k, []))} / {len(b.get(k, []))} "
              f"instructions) {k}")
    return differ


def time_variants(libs: dict, calls: dict, turns: int = 2) -> None:
    """Print the device time (``cuda_ms``) of each of ``calls`` ({label:
    zero-argument call through the wrappers}) on each build, every build
    ``turns`` times, in turns; the wrappers launch the build's kernels."""
    saved = _cuda._lib
    try:
        for turn in range(turns):
            for name, lib in libs.items():
                _cuda._lib = lib
                times = [f"{what} {cuda_ms(fn):.4f} ms"
                         for what, fn in calls.items()]
                print(f"turn {turn} {name}: " + ", ".join(times))
    finally:
        _cuda._lib = saved


# K5's, K6 / K7's and K8's sources: the header that holds the kernels,
# and the translation units that build it (the entry points and one per
# width)
K5_HEADER = "post_attention.cuh"
K5_UNITS = ("post_attention.cu",
            *sorted(p.name for p in _cuda.CSRC.glob("post_attention_c*.cu")))
QKV_HEADER = "window_attention.cuh"
QKV_UNITS = ("window_attention.cu",
             *sorted(p.name for p in
                     _cuda.CSRC.glob("window_attention_c*.cu")))
K8_HEADER = "band_attention.cuh"
K8_UNITS = ("band_attention.cu",
            *sorted(p.name for p in _cuda.CSRC.glob("band_attention_c*.cu")))
