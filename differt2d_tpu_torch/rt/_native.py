"""ctypes binding of the native candidate enumerator (counterpart of
:mod:`differt2d_tpu.rt._native`).

The port's copy of ``native/enumerate.cc``
(``differt2d_tpu_torch/ops/csrc/enumerate.cc``) is built by the host C++
compiler at first use (:mod:`differt2d_tpu_torch.ops._build`) and called
with the JAX package's ABI.  A build that fails raises with the compiler's
output: :func:`differt2d_tpu_torch.rt.graph._decode_candidates` sends every
set of :data:`NATIVE_THRESHOLD` rows or more here, and never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

SOURCE = "enumerate.cc"

NATIVE_THRESHOLD = 1024
"""Row count from which the native enumerator runs.  ``chip_smoke.py``
phase 25 d) times both on the host: the native one is faster from about
1,000 rows (2.6 times at 4,160, 3.1 at 18,360, 10.6 at 2,478,600 on an
H100 machine's host); below that the two are within a few microseconds,
call overhead either way.  The JAX package switches at 4,096 rows; the
arrays are the same either way."""

_I32P = ctypes.POINTER(ctypes.c_int32)


def _declare(lib: ctypes.CDLL) -> None:
    lib.enumerate_paths.restype = ctypes.c_int64
    lib.enumerate_paths.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64, _I32P]
    lib.num_candidates.restype = ctypes.c_int64
    lib.num_candidates.argtypes = [ctypes.c_int64, ctypes.c_int64]


def load_library() -> ctypes.CDLL:
    """The enumerator's library, built on first use."""
    return _build.load(SOURCE, _declare)


def available() -> bool:
    """Whether the native enumerator loads (building it on first use).  A
    failed build only makes this ``False``: the sets that need the library
    still raise with the compiler's output."""
    try:
        load_library()
    except (OSError, RuntimeError):
        return False
    return True


def enumerate_paths(allowed: np.ndarray, order: int) -> np.ndarray:
    """Every sequence of ``order`` nodes of ``allowed`` (sorted unique
    ``int[m]``) with no two consecutive repeats, in lexicographic order:
    ``int32[m * (m - 1)**(order - 1), order]``."""
    lib = load_library()
    allowed = np.ascontiguousarray(allowed, dtype=np.int32)
    total = lib.num_candidates(allowed.shape[0], order)
    out = np.empty((total, order), dtype=np.int32)
    written = lib.enumerate_paths(allowed.ctypes.data_as(_I32P), allowed.shape[0], order,
                                  out.ctypes.data_as(_I32P))
    if written != total:
        msg = f"the native enumerator wrote {written} rows of {total}"
        raise RuntimeError(msg)
    return out
