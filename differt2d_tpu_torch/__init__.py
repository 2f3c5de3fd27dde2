"""PyTorch/CUDA port of :mod:`differt2d_tpu`, the differentiable 2D radio ray
tracer.

The JAX package stays the reference; this package mirrors its structure
(``logic``, ``rt``, ``ops.geometry_ops``, ``abc``, ``geometry``,
``optimize``, ``scene``, ``tracer``, whose batched part is :mod:`.eager`,
``utils``) in PyTorch and runs its power-map hot path through hand-written
CUDA kernels for NVIDIA Hopper (:mod:`differt2d_tpu_torch.ops.power_map_kernel`).
It imports neither JAX nor the JAX package.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
another device.  They check their arguments as the JAX package's do
(:class:`TypeCheckError`; :func:`no_typecheck` and :func:`set_typecheck`
turn the checks off), at the entry points only.
"""

from ._runtime_typing import TypeCheckError, no_typecheck, set_typecheck
from .geometry import RIS, FermatPath, ImagePath, MinPath, Path, Point, Ray, Vertex, Wall
from .scene import Scene, load_scene_arrays
from .tracer import power_map, trace_paths
from .utils import P0, received_power

__version__ = "0.1.0"

__all__ = (
    "P0",
    "RIS",
    "FermatPath",
    "ImagePath",
    "MinPath",
    "Path",
    "Point",
    "Ray",
    "Scene",
    "TypeCheckError",
    "Vertex",
    "Wall",
    "__version__",
    "load_scene_arrays",
    "no_typecheck",
    "power_map",
    "received_power",
    "set_typecheck",
    "trace_paths",
)
