"""PyTorch/CUDA port of :mod:`differt2d_tpu`, the differentiable 2D radio ray
tracer.

The JAX package stays the reference; this package mirrors its structure
(``logic``, ``rt``, ``ops.geometry_ops``, ``scene``, ``tracer``, whose
batched part is :mod:`.eager`) in PyTorch and runs its power-map hot path
through hand-written CUDA kernels for NVIDIA Hopper (:mod:`differt2d_tpu_torch.ops.power_map_kernel`).  It
imports neither JAX nor the JAX package.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
another device.
"""

from .scene import Scene, load_scene_arrays
from .tracer import power_map

__version__ = "0.1.0"

__all__ = ("Scene", "__version__", "load_scene_arrays", "power_map")
