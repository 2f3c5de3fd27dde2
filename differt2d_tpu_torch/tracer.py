"""The power-map entry point and its dispatch.

Counterpart of the entry part of :mod:`differt2d_tpu.tracer`:
:func:`power_map` sends each request either to the CUDA kernels of
:mod:`differt2d_tpu_torch.ops.power_map_kernel` (``"cuda"``) or to the
batched eager tracer of :mod:`differt2d_tpu_torch.eager` (``"torch"``), by
the rules the JAX package uses to choose its Pallas kernels
(:func:`_kernel_eligible`).  Pixel gradients come from autograd: the map is
independent per pixel, so the backward of ``Z.sum()`` with respect to the
pixels is the pixel gradient.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .defaults import (
    DEFAULT_ALPHA,
    DEFAULT_DEVICE,
    DEFAULT_HEIGHT,
    DEFAULT_PATCH,
    DEFAULT_R_COEF,
    KIND_RIS,
    KIND_VERTEX,
    KIND_WALL,
    resolve_device,
)
from .eager import EagerSpec, SceneArrays, eager_value, eager_value_and_grad, make_groups
from . import logic
from .logic import hard_sigmoid, sigmoid
from .ops import power_map_kernel
from .rt import path_candidate_matrices

__all__ = ("KIND_RIS", "KIND_VERTEX", "KIND_WALL", "SceneArrays", "power_map")

# Stream-proxy bounds of the JAX package's choice between its unrolled and
# looped Pallas kernels (``differt2d_tpu/ops/pallas_kernels.py``,
# ``get_fused_run``): above them it runs the looped kernel.
_UNROLLED_MAX_PROXY_VALUE = 1200
_UNROLLED_MAX_PROXY_GRAD = 400

_SCALAR_NAMES = ("alpha", "tol", "patch", "r_coef", "height")
_OPTIONS = {
    "min_order": 0,
    "max_order": 1,
    "order": None,
    "solver": "image",
    "approx": None,
    "alpha": DEFAULT_ALPHA,
    "function": hard_sigmoid,
    "tol": 1e-2,
    "patch": DEFAULT_PATCH,
    "r_coef": DEFAULT_R_COEF,
    "height": DEFAULT_HEIGHT,
    "steps": 100,
    "many": 1,
    "solver_grad": "unroll",
    "key": None,
    "filter_objects": None,
    "on_transmitters": False,
    "power_fun": None,
}


# -- dispatch -------------------------------------------------------------------


def _filter_nodes(scene, filter_objects) -> Optional[tuple]:
    if filter_objects is None:
        return None
    return tuple(o.index for o in scene.objects if not filter_objects(o))


def _all_vertex_allowed(scene, filter_objects) -> bool:
    """Whether every object that may enter a candidate is a vertex."""
    allowed = [
        o for o in scene.objects if filter_objects is None or filter_objects(o)
    ]
    return bool(allowed) and all(o.kind == KIND_VERTEX for o in allowed)


def _groups_for(scene, kw) -> dict:
    return path_candidate_matrices(
        scene.num_objects,
        min_order=kw["min_order"],
        max_order=kw["max_order"],
        order=kw["order"],
        filter_nodes=_filter_nodes(scene, kw["filter_objects"]),
    )


def _max_order(groups: dict) -> int:
    """Highest order with at least one candidate (0 for none)."""
    return max((o for o, g in groups.items() if g.shape[0]), default=0)


def _image_paths(scene, kw) -> bool:
    """Whether the request's paths come from the image method: the image
    solver, or Fermat/MPT over vertices only (every bounce is pinned, so
    nothing is left to solve)."""
    return kw["solver"] == "image" or (
        kw["solver"] in ("fermat", "mpt")
        and _all_vertex_allowed(scene, kw["filter_objects"])
    )


def stream_proxy(groups: dict, num_walls: int) -> int:
    """The JAX package's measure of an unrolled kernel's size:
    sum over order groups of ``candidates x walls x segments``."""
    return sum(int(g.shape[0]) * num_walls * (o + 1) for o, g in groups.items())


def _concrete_scalar(value) -> bool:
    """Whether ``value`` is a host or 0-d tensor scalar with a readable value."""
    if isinstance(value, torch.Tensor):
        if value.numel() != 1 or value.dim() > 1:
            return False
        try:
            float(value.detach())
        except (RuntimeError, TypeError, ValueError):
            return False
        return True
    try:
        float(value)
    except (TypeError, ValueError):
        return False
    return True


def _kernel_eligible(
    scene, kw: dict, *, grad: bool = False, groups: Optional[dict] = None
) -> tuple[bool, str]:
    """Whether the JAX package serves this request with a Pallas kernel,
    and why.

    Applies the rules of ``differt2d_tpu.tracer._pallas_eligible`` as they
    stand on a TPU.  ``kw`` holds :func:`power_map` options (missing ones
    take their defaults); ``groups`` are the request's candidates (derived
    from ``kw`` when not given).  The reason of an eligible request names
    the kernel family the JAX package would pick (``"unrolled"``,
    ``"looped"`` or ``"solver"``); only the unrolled one is ported.
    """
    kw = {**_OPTIONS, **kw}
    solver = kw["solver"]
    image = _image_paths(scene, kw)
    if solver in ("fermat", "mpt") and not image:
        if grad:
            return False, f"gradient maps of solver {solver!r} run on the tracer"
        if kw["key"] is None:
            return False, f"solver {solver!r} without a key runs on the tracer"
        order, max_order = kw["order"], kw["max_order"]
        if (order is None and max_order > 1) or (order is not None and order > 1):
            return False, f"solver {solver!r} above order 1 runs on the tracer"
        if KIND_VERTEX in scene.kinds:
            return False, f"solver {solver!r} with vertices runs on the tracer"
    elif solver not in ("image", "fermat", "mpt"):
        return False, f"unknown solver {solver!r}"
    if kw["power_fun"] is not None:
        return False, "a custom power_fun runs on the tracer"
    if kw["many"] != 1:
        return False, "many != 1 runs on the tracer"
    if kw["solver_grad"] != "unroll":
        return False, "solver_grad other than 'unroll' runs on the tracer"
    for name in _SCALAR_NAMES:
        if not _concrete_scalar(kw[name]):
            return False, f"{name} is not a concrete scalar"
    if kw["function"] not in (hard_sigmoid, sigmoid):
        return False, "activation other than hard_sigmoid/sigmoid"
    if kw["on_transmitters"] and KIND_RIS in scene.kinds:
        return False, "on_transmitters with RIS breaks path-reversal symmetry"
    if not image:
        return True, (
            f"solver kernel: order-1 {solver} solve (pallas_solver"
            ".build_opt_order1_kernel), not yet ported (ROADMAP §1 item 9)"
        )
    if groups is None:
        groups = _groups_for(scene, kw)
    proxy = stream_proxy(groups, scene.num_objects)
    limit = _UNROLLED_MAX_PROXY_GRAD if grad else _UNROLLED_MAX_PROXY_VALUE
    if proxy > limit:
        return True, (
            f"looped kernel: stream proxy {proxy} > {limit}"
            " (build_power_map_kernel_looped), not yet ported"
            " (ROADMAP §1 item 8)"
        )
    return True, f"unrolled kernel: stream proxy {proxy} <= {limit}"


def _route(scene, kw: dict, groups: dict, backend: str, *, grad: bool) -> str:
    """``"cuda"`` or ``"torch"`` for this request, or raise.

    Fermat/MPT solves are not ported on either route, so they raise.
    ``"auto"`` takes the kernel wherever the JAX package takes its unrolled
    kernel, and the eager tracer wherever it takes its XLA tracer.  Where
    it would take a kernel that is not ported yet, it raises: it never
    runs such a request somewhere slower without being asked.
    """
    ok, reason = _kernel_eligible(scene, kw, grad=grad, groups=groups)
    if kw["solver"] not in ("image", "fermat", "mpt"):
        raise ValueError(reason)
    if not _image_paths(scene, kw):
        msg = (
            f"solver {kw['solver']!r} is not ported yet (ROADMAP §1 item 9:"
            f" optimizer + Fermat/MPT, then kernel B6); the JAX package: {reason}"
        )
        raise NotImplementedError(msg)
    if backend == "torch":
        return "torch"
    if not ok:
        if backend == "cuda":
            msg = f"backend='cuda' does not cover this request: {reason}"
            raise ValueError(msg)
        return "torch"
    if not reason.startswith("unrolled"):
        msg = f"{reason}; pass backend='torch' to run it on the eager tracer"
        raise NotImplementedError(msg)
    cap = power_map_kernel.kernel_caps_reason(scene.num_objects, _max_order(groups))
    if cap is not None:
        msg = f"{cap}; pass backend='torch' to run it on the eager tracer"
        raise NotImplementedError(msg)
    return "cuda"


def power_map(
    scene,
    X,
    Y,
    *,
    grad: bool = False,
    value_and_grad: bool = False,
    backend: str = "auto",
    device=DEFAULT_DEVICE,
    **kwargs: Any,
):
    """Received-power grid map, summed over the scene's fixed nodes.

    Counterpart of ``differt2d_tpu.tracer.power_map``: the pixels of the
    ``X``/``Y`` grid are the receivers (or, with ``on_transmitters=True``,
    the transmitters), and every path candidate between them and each
    fixed node adds ``valid * r_coef**order / (height**2 + r**2)``.

    ``backend``: ``"auto"`` runs the CUDA kernels for every request they
    cover and the eager tracer for requests the JAX package sends to its
    XLA tracer; it raises for requests the JAX package sends to a kernel
    not ported yet.  ``"cuda"`` forces the kernels (and raises on what
    they do not cover); ``"torch"`` forces the eager tracer.  On a CPU
    device the kernels' plain PyTorch versions stand in for them.

    ``device`` defaults to ``"cuda"``; without a GPU, pass ``"cpu"``.

    >>> from differt2d_tpu_torch.scene import Scene
    >>> scene = Scene.basic_scene(device="cpu")
    >>> X, Y = scene.grid(4, 3)
    >>> power_map(scene, X, Y, approx=True, device="cpu").shape
    torch.Size([3, 4])

    :return: ``[m, n]`` map, ``[m, n, 2]`` gradient (``grad``), or the
        ``(value, gradient)`` pair (``value_and_grad``).
    """
    unknown = set(kwargs) - set(_OPTIONS)
    if unknown:
        msg = f"unknown power_map options: {sorted(unknown)}"
        raise TypeError(msg)
    if backend not in ("auto", "torch", "cuda"):
        msg = f"backend must be 'auto', 'torch' or 'cuda', got {backend!r}"
        raise ValueError(msg)
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    Y = torch.as_tensor(Y).to(device=dev, dtype=torch.float32)
    if X.shape != Y.shape:
        msg = f"X and Y must have the same shape, got {tuple(X.shape)} vs {tuple(Y.shape)}"
        raise ValueError(msg)
    if X.dim() != 2:
        msg = f"X and Y must be 2-D grids, got ndim={X.dim()}"
        raise ValueError(msg)
    scene = scene.to(dev)
    kw = {**_OPTIONS, **kwargs}
    if kw["approx"] is None:
        kw["approx"] = bool(logic.ENABLE_APPROX)
    want_grad = grad or value_and_grad
    groups = _groups_for(scene, kw)
    route = _route(scene, kw, groups, backend, grad=want_grad)
    if route == "cuda":
        Z = power_map_kernel.power_map_kernel(
            scene, X, Y, groups, want_grad=want_grad,
            approx=kw["approx"], sigmoid=kw["function"] is sigmoid,
            on_transmitters=kw["on_transmitters"],
            scalars=tuple(kw[name] for name in _SCALAR_NAMES),
        )
    else:
        spec = EagerSpec(
            groups=make_groups(groups, dev),
            approx=bool(kw["approx"]),
            function=kw["function"],
            on_transmitters=bool(kw["on_transmitters"]),
            power_fun=kw["power_fun"],
        )
        points = scene.receivers if kw["on_transmitters"] else scene.transmitters
        fixed = (
            torch.stack(list(points.values()))
            if points
            else torch.zeros(0, 2, device=dev)
        )
        pixels = torch.stack([X.reshape(-1), Y.reshape(-1)], dim=-1)
        scalars = tuple(kw[name] for name in _SCALAR_NAMES)
        run = eager_value_and_grad if want_grad else eager_value
        Z = run(pixels, fixed, scene.walls, scene.kind, scene.phi, scalars, spec)
    if value_and_grad:
        z, dz = Z
        return z.reshape(X.shape), dz.reshape(*X.shape, 2)
    if grad:
        return Z[1].reshape(*X.shape, 2)
    return Z.reshape(X.shape)
