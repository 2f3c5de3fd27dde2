"""Build and load the CUDA kernels of this package.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so
a build takes seconds).  Builds happen at first use, never at import,
into ``build/differt2d_tpu_torch/`` beside the package, under a file name
keyed on a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No FMA contraction: the kernels round each operation as the plain
    # PyTorch versions do (see csrc/power_map.cu).
    "-fmad=false",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}
"""nvcc output (ptxas register and spill report) of each build, by source."""


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "differt2d_tpu_torch")


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the CUDA toolkit's default place."""
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    msg = "nvcc not found (put the CUDA toolkit's bin directory on PATH)"
    raise RuntimeError(msg)


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name under ``csrc/``) goes."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}_{digest[:16]}.so")


def build(source: str) -> tuple[str, float]:
    """Compile ``csrc/<source>`` if its library is missing.

    Returns ``(library path, seconds spent compiling)`` (0 when the
    library was already built).  Concurrent builds serialize on a lock
    file; the library appears under its final name only when complete.
    """
    out = library_path(source)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(build_dir(), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out, 0.0
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            seconds = time.perf_counter() - t0
            BUILD_LOG[source] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                msg = f"nvcc failed on {source} (exit {proc.returncode}):\n{BUILD_LOG[source]}"
                raise RuntimeError(msg)
            os.replace(tmp, out)
            return out, seconds
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load(source: str, declare=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use.

    ``declare(lib)`` sets ``argtypes``/``restype`` once, when it is loaded.
    """
    with _LOCK:
        lib: Optional[ctypes.CDLL] = _LIBS.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(path)
            if declare is not None:
                declare(lib)
            _LIBS[source] = lib
        return lib
