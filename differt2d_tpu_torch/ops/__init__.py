"""Geometry primitives and the power-map kernels.

Counterpart of :mod:`differt2d_tpu.ops`.  :mod:`.power_map_kernel` holds the
wrappers of the two hand-written CUDA kernels (``csrc/power_map.cu``),
built at first use by :mod:`._build`; nothing here compiles or imports a
GPU toolchain at import time.
"""

from . import geometry_ops

__all__ = ("geometry_ops",)
