"""Builds and loads the port's hand-written CUDA kernels; counts launches.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` into a
shared library with a plain C interface (``build/`` at the repository
root, named by a hash of the source and flags so an edited source is
rebuilt), loaded with ``ctypes`` and called on PyTorch's current stream.
The headers the sources share (``kernels/*.cuh``) are part of that hash.
Nothing is built when a module is imported, so the CPU tests import every
module on machines without ``nvcc``.

``launches`` counts each kernel launch by name.  A wrapper adds one right
after its kernel was launched without error, and nowhere else, so a run
can show which kernels its path went through.

``clusters`` keeps, per kernel shape and device, how many CTAs of a
thread-block cluster the library chose for one unit of work (``cluster``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
HEADERS = Path(__file__).resolve().parent   # shared headers, *.cuh
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()
clusters: dict = {}
_LIBS: dict = {}


def reset_launches() -> None:
    launches.clear()


def launched(name: str) -> None:
    launches[name] += 1


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: Path) -> Path:
    """Compile ``source`` into ``build/`` unless that exact build exists."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(HEADERS.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(source: Path, signatures: dict) -> ctypes.CDLL:
    """Load (building first if needed) ``source``'s library once per
    process and declare each function's argument types; every function
    returns a ``cudaError_t`` as int."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def cluster_key(fn: str, args: tuple, device) -> tuple:
    """Key of ``clusters``: the chooser ``fn``'s arguments on one device."""
    return (fn, *args, torch.device(device).index)


def cluster(lib: ctypes.CDLL, fn: str, args: tuple, device) -> int:
    """CTAs a unit of work of one kernel spreads over on ``device``: the
    choice of ``lib.fn(*args, &c)`` from the device's cluster occupancy,
    asked once per shape and kept in ``clusters`` (a test forces a size by
    setting the entry).  A shape the chooser refuses raises ValueError."""
    key = cluster_key(fn, args, device)
    if key not in clusters:
        got = ctypes.c_int()
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args, ctypes.byref(got))
        if err == 1:   # cudaErrorInvalidValue
            raise ValueError(f"{fn}: shape {args} unsupported")
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err} reading the "
                               f"device's cluster occupancy")
        clusters[key] = got.value
    return clusters[key]
