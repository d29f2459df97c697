"""Builds and loads the port's hand-written CUDA kernels; counts launches.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` into a
shared library with a plain C interface (``build/`` at the repository
root, named by a hash of the source and flags so an edited source is
rebuilt), loaded with ``ctypes`` and called on PyTorch's current stream.
Nothing is built when a module is imported, so the CPU tests import every
module on machines without ``nvcc``.

``launches`` counts each kernel launch by name.  A wrapper adds one right
after its kernel was launched without error, and nowhere else, so a run
can show which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()
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
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
