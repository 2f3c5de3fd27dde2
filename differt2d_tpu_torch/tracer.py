"""The power-map entry point and its dispatch.

Counterpart of the entry part of :mod:`differt2d_tpu.tracer`:
:func:`power_map` sends each request to the unrolled CUDA kernels of
:mod:`differt2d_tpu_torch.ops.power_map_kernel` (``"cuda"``), to the looped
ones of :mod:`differt2d_tpu_torch.ops.power_map_looped` (``"looped"``), to
the order-1 Fermat/MPT solver kernel of
:mod:`differt2d_tpu_torch.ops.opt_solver_kernel` (``"solver"``) or to the
batched eager tracer of :mod:`differt2d_tpu_torch.eager` (``"torch"``), by
the rules the JAX package uses to choose its Pallas kernels
(:func:`_kernel_eligible`), and sets the looped kernels' culling gates as
``get_fused_run`` does (:func:`_looped_gates`).
Pixel gradients of the eager route come from autograd: the map is
independent per pixel, so the backward of ``Z.sum()`` with respect to the
pixels is the pixel gradient.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
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
from .eager import (
    EagerSpec,
    SceneArrays,
    _trace_group,
    eager_value,
    eager_value_and_grad,
    group_keys,
    make_groups,
)
from . import logic, optimize, prng
from ._runtime_typing import (
    OPT_BOOL,
    OPT_CALLABLE,
    OPT_KEY_ARRAY,
    SCALAR_INT_STRICT,
    XY_ARRAY,
    TypeCheckError,
    literal_spec,
    typecheck,
    unchecked,
)
from .logic import _hard_sigmoid, _sigmoid
from .ops import opt_solver_kernel, power_map_kernel, power_map_looped
from .ops.cull_tables import _SIGMOID_Z0
from .rt import path_candidate_matrices

__all__ = (
    "KIND_RIS", "KIND_VERTEX", "KIND_WALL", "SceneArrays", "make_pixels_fn", "power_map",
    "scene_arrays", "trace_paths",
)

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
    "function": _hard_sigmoid,
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


def scene_arrays(scene) -> SceneArrays:
    """The scene's dense tensors (``differt2d_tpu.tracer.scene_arrays``,
    which builds them from the objects; a port scene holds them already)."""
    return SceneArrays(walls=scene.walls, kind=scene.kind, phi=scene.phi)


# -- dispatch -------------------------------------------------------------------


def _filter_nodes(scene, filter_objects) -> Optional[tuple]:
    """Positions of the objects ``filter_objects`` rejects (it is called on
    the scene's object views, which copy nothing from the device)."""
    if filter_objects is None:
        return None
    return tuple(i for i, o in enumerate(scene.objects) if not filter_objects(o))


def _all_vertex_allowed(scene, filter_objects) -> bool:
    """Whether every object that may enter a candidate is a vertex, by the
    host-side kinds."""
    if filter_objects is None:
        allowed = scene.kinds
    else:
        allowed = [k for k, o in zip(scene.kinds, scene.objects) if filter_objects(o)]
    return bool(allowed) and all(k == KIND_VERTEX for k in allowed)


def _groups_for(scene, kw) -> dict:
    return unchecked(path_candidate_matrices)(
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
    ``"looped"`` or ``"solver"``); all three are ported (the port's
    kernels cap the order and the object count: ``kernel_caps_reason``).
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
    if unchecked(kw["function"]) not in (_hard_sigmoid, _sigmoid):
        return False, "activation other than hard_sigmoid/sigmoid"
    if kw["on_transmitters"] and KIND_RIS in scene.kinds:
        return False, "on_transmitters with RIS breaks path-reversal symmetry"
    if not image:
        return True, (
            f"solver kernel: order-1 {solver} solve"
            " (pallas_solver.build_opt_order1_kernel: opt_solver_kernel)"
        )
    if groups is None:
        groups = _groups_for(scene, kw)
    proxy = stream_proxy(groups, scene.num_objects)
    limit = _UNROLLED_MAX_PROXY_GRAD if grad else _UNROLLED_MAX_PROXY_VALUE
    if proxy > limit:
        return True, (
            f"looped kernel: stream proxy {proxy} > {limit}"
            " (build_power_map_kernel_looped: power_map_looped)"
        )
    return True, f"unrolled kernel: stream proxy {proxy} <= {limit}"


def _route(scene, kw: dict, groups: dict, backend: str, *, grad: bool) -> str:
    """``"cuda"``, ``"looped"``, ``"solver"`` or ``"torch"`` for this
    request, or raise.

    ``"auto"`` takes the unrolled, looped or solver kernels wherever the
    JAX package takes them, and the eager tracer wherever it takes its XLA
    tracer (among them Fermat/MPT gradient maps, ``many > 1``, orders above
    1, scenes with vertices and requests without a key).  Where the port's
    kernel cannot take a request the JAX package sends to its kernel (above
    a kernel's order or object cap), it raises: it never runs such a
    request somewhere slower without being asked.  ``"cuda"`` means any
    kernel family, and raises with the reason where none covers the
    request.
    """
    ok, reason = _kernel_eligible(scene, kw, grad=grad, groups=groups)
    if kw["solver"] not in ("image", "fermat", "mpt"):
        raise ValueError(reason)
    if backend == "torch":
        return "torch"
    if not ok:
        if backend == "cuda":
            msg = f"backend='cuda' does not cover this request: {reason}"
            raise ValueError(msg)
        return "torch"
    if reason.startswith("unrolled"):
        route, caps = "cuda", power_map_kernel.kernel_caps_reason
    elif reason.startswith("looped"):
        route, caps = "looped", power_map_looped.kernel_caps_reason
    else:
        route, caps = "solver", opt_solver_kernel.kernel_caps_reason
    cap = caps(scene.num_objects, _max_order(groups))
    if cap is not None:
        msg = f"{cap}; pass backend='torch' to run it on the eager tracer"
        raise NotImplementedError(msg)
    return route


def _looped_gates(scene, kw: dict, groups: dict) -> tuple[bool, bool]:
    """``(cull, shadow)`` of a looped request, by ``get_fused_run``'s gates
    (``pallas_kernels.py:3985-4059``).

    Candidate sets of vertices only have no bounce to cull (identity keep
    tables; the occluder lists stay).  Sigmoid maps need the kernels'
    sigmoid to saturate exactly (:func:`power_map_looped.sigmoid_saturates`
    on the scene's device) and a band ``Z0 / alpha`` under a quarter of the
    scene's diagonal; otherwise both tables are identity tables.
    """
    any_cullable = any(
        o >= 1 and g.size and any(scene.kinds[i] != KIND_VERTEX for i in np.ravel(g))
        for o, g in groups.items()
    )
    approx, sig = bool(kw["approx"]), _is_sigmoid(kw)
    ok = True
    if approx and sig:
        walls = np.asarray(optimize.constants(scene.walls.detach().reshape(-1, 2).cpu()).tolist(),
                           dtype=np.float32)
        diag = float(np.sqrt(np.sum((walls.max(axis=0) - walls.min(axis=0)) ** 2))) or 1.0
        band = _SIGMOID_Z0 / max(float(kw["alpha"]), 1e-6)
        ok = band < 0.25 * diag and power_map_looped.sigmoid_saturates(scene.device)
    return any_cullable and ok, ok


def _solver_options(kw: dict) -> dict:
    """The keywords of ``opt_solver_kernel.solver_request`` for the merged
    options ``kw`` of a solver-routed request."""
    return dict(
        solver=kw["solver"], steps=int(kw["steps"]), key=kw["key"], approx=kw["approx"],
        sigmoid=_is_sigmoid(kw), on_transmitters=kw["on_transmitters"],
        scalars=tuple(kw[name] for name in _SCALAR_NAMES),
    )


def _is_sigmoid(kw: dict) -> bool:
    """Whether the request's activation is :func:`~differt2d_tpu_torch.logic.sigmoid`
    (the public, checked function or its body)."""
    return unchecked(kw["function"]) is _sigmoid


@typecheck(
    approx=OPT_BOOL,
    key=OPT_KEY_ARRAY,
    min_order=SCALAR_INT_STRICT,
    max_order=SCALAR_INT_STRICT,
    filter_objects=OPT_CALLABLE,
    solver=literal_spec("image", "fermat", "mpt"),
    backend=literal_spec("auto", "torch", "cuda"),
)
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
    cover (the unrolled ones for small candidate streams, the looped,
    culled ones for larger ones such as city-scale scenes, at orders <= 4,
    the adam solver for keyed order-1 Fermat/MPT value maps) and the eager
    tracer for requests the JAX package sends to its XLA tracer; it raises
    for requests the JAX package sends to a kernel that the port's kernels
    cannot take (above order 4 or 512 objects).  ``"cuda"`` forces the kernels (and raises on what they do not
    cover); ``"torch"`` forces the eager tracer.  On a CPU device the
    kernels' plain PyTorch versions stand in for them.

    ``solver="fermat"`` or ``"mpt"`` solves each bounce with ``steps`` adam
    steps from a uniform draw of ``key`` (a ``uint32[2]`` key of
    :mod:`differt2d_tpu_torch.prng`, equal to JAX's for the same seed), the
    best of ``many`` starts.  Their derivatives (pixel gradients, autograd,
    ``torch.func``) go through the unrolled steps, or, with
    ``solver_grad="implicit"``, through the implicit-function theorem at
    each solution (``optimize.minimize(implicit=True)``; the eager tracer,
    as in the JAX package).

    ``device`` defaults to ``"cuda"``; without a GPU, pass ``"cpu"``.

    >>> from differt2d_tpu_torch.scene import Scene
    >>> scene = Scene.basic_scene(device="cpu")
    >>> X, Y = scene.grid(4, 3)
    >>> power_map(scene, X, Y, approx=True, device="cpu").shape
    torch.Size([3, 4])

    :return: ``[m, n]`` map, ``[m, n, 2]`` gradient (``grad``), or the
        ``(value, gradient)`` pair (``value_and_grad``).
    """
    kw = _options(kwargs, backend)
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    Y = torch.as_tensor(Y).to(device=dev, dtype=torch.float32)
    if X.shape != Y.shape:
        msg = f"X and Y must have the same shape, got {tuple(X.shape)} vs {tuple(Y.shape)}"
        raise TypeCheckError(msg)
    if X.dim() != 2:
        msg = f"X and Y must be 2-D grids, got ndim={X.dim()}"
        raise TypeCheckError(msg)
    scene = scene.to(dev)
    return map_groups(scene, X, Y, _groups_for(scene, kw), kw, backend=backend, grad=grad,
                      value_and_grad=value_and_grad)


def _options(kwargs: dict, backend: str) -> dict:
    """:func:`power_map`'s options ``kwargs`` checked and merged over the
    defaults."""
    unknown = set(kwargs) - set(_OPTIONS)
    if unknown:
        msg = f"unknown power_map options: {sorted(unknown)}"
        raise TypeError(msg)
    if backend not in ("auto", "torch", "cuda"):
        msg = f"backend must be 'auto', 'torch' or 'cuda', got {backend!r}"
        raise ValueError(msg)
    kw = {**_OPTIONS, **kwargs}
    # The kernels' plain versions and the eager tracer call the activation
    # per operation: its body, unchecked.
    kw["function"] = unchecked(kw["function"])
    if kw["approx"] is None:
        kw["approx"] = bool(logic.ENABLE_APPROX)
    for name in ("steps", "many"):
        if int(kw[name]) != kw[name] or kw[name] < 1:
            msg = f"{name} must be a positive integer, got {kw[name]!r}"
            raise ValueError(msg)
    if kw["key"] is not None:
        kw["key"] = prng.as_key(kw["key"])
    return kw


def map_groups(scene, X, Y, groups: dict, kw: dict, *, backend: str, grad: bool = False,
               value_and_grad: bool = False):
    """:func:`power_map` over the candidates ``groups`` (``{order: int32[C,
    order]}``, any subset of the request's), by the route ``power_map``
    takes for them.

    ``scene``, ``X`` and ``Y`` are on one device, ``kw`` holds every option
    (:func:`_options`).  The candidate-sharded map runs each rank's share of
    the candidates through it.
    """
    dev = X.device
    want_grad = grad or value_and_grad
    route = _route(scene, kw, groups, backend, grad=want_grad)
    if route == "looped":
        cull, shadow = _looped_gates(scene, kw, groups)
        Z = power_map_looped.power_map_looped(
            scene, X, Y, groups, want_grad=want_grad,
            approx=kw["approx"], sigmoid=_is_sigmoid(kw),
            on_transmitters=kw["on_transmitters"],
            scalars=tuple(kw[name] for name in _SCALAR_NAMES), cull=cull, shadow=shadow,
        )
    elif route == "solver":
        Z = opt_solver_kernel.solver_map(scene, X, Y, groups, **_solver_options(kw))
    elif route == "cuda":
        Z = power_map_kernel.power_map_kernel(
            scene, X, Y, groups, want_grad=want_grad,
            approx=kw["approx"], sigmoid=_is_sigmoid(kw),
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
            solver=kw["solver"],
            steps=int(kw["steps"]),
            many=int(kw["many"]),
            keys=None if kw["key"] is None else group_keys(groups, kw["key"]),
            kinds=scene.kinds,
            implicit=kw["solver_grad"] == "implicit",
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


def make_pixels_fn(
    scene,
    *,
    grad: bool = False,
    value_and_grad: bool = False,
    backend: str = "auto",
    device=DEFAULT_DEVICE,
    cols: Optional[int] = None,
    **kwargs: Any,
):
    """The flat-pixel map ``f(pixels[P, 2])`` of :func:`power_map`'s request
    (``differt2d_tpu.tracer.make_pixels_fn``): ``[P]``, ``[P, 2]`` with
    ``grad``, or ``([P], [P, 2])`` with ``value_and_grad``.

    ``f`` takes the pixels as the rows of a grid ``cols`` wide, in
    row-major order (default: one row of ``P``), and maps that grid by
    :func:`power_map`'s routes.  The result does not depend on ``cols``, but
    the looped route culls per 16 x 16 tile of that grid, so a caller with
    rows of a grid (a rank's rows from ``parallel.host_local_pixels``)
    passes its width.  Options are checked, and the device resolved, when
    ``f`` is made.

    >>> from differt2d_tpu_torch.scene import Scene
    >>> scene = Scene.basic_scene(device="cpu")
    >>> f = make_pixels_fn(scene, approx=True, device="cpu")
    >>> f(torch.tensor([[0.5, 0.5], [0.7, 0.2]])).shape
    torch.Size([2])
    """
    kw = _options(kwargs, backend)
    dev = resolve_device(device)
    scene = scene.to(dev)
    groups = _groups_for(scene, kw)

    def run(pixels):
        pixels = torch.as_tensor(pixels).to(device=dev, dtype=torch.float32)
        if pixels.dim() != 2 or pixels.shape[1] != 2:
            msg = f"pixels must be [P, 2], got {tuple(pixels.shape)}"
            raise ValueError(msg)
        width = cols or max(pixels.shape[0], 1)
        if pixels.shape[0] % width:
            msg = f"{pixels.shape[0]} pixels are not rows of {width}"
            raise ValueError(msg)
        X = pixels[:, 0].reshape(-1, width)
        Y = pixels[:, 1].reshape(-1, width)
        out = map_groups(scene, X, Y, groups, kw, backend=backend, grad=grad,
                         value_and_grad=value_and_grad)
        if value_and_grad:
            return out[0].reshape(-1), out[1].reshape(-1, 2)
        return out.reshape(-1, 2) if grad else out.reshape(-1)

    return run


@typecheck(
    tx=XY_ARRAY,
    rx=XY_ARRAY,
    approx=OPT_BOOL,
    key=OPT_KEY_ARRAY,
    min_order=SCALAR_INT_STRICT,
    max_order=SCALAR_INT_STRICT,
    filter_objects=OPT_CALLABLE,
    solver=literal_spec("image", "fermat", "mpt"),
)
def trace_paths(
    scene,
    tx,
    rx,
    *,
    min_order: int = 0,
    max_order: int = 1,
    order: Optional[int] = None,
    solver: str = "image",
    approx: Optional[bool] = None,
    alpha=DEFAULT_ALPHA,
    function=logic.hard_sigmoid,
    tol=1e-2,
    patch=DEFAULT_PATCH,
    steps: int = 100,
    many: int = 1,
    key=None,
    filter_objects=None,
    device=DEFAULT_DEVICE,
) -> dict:
    """Every path candidate of one transmitter-receiver pair, traced in
    batches per order (``differt2d_tpu.tracer.trace_paths``).

    Keys: one per candidate from ``prng.split(key, total)`` in order-major
    enumeration, as :func:`power_map` draws them.

    :return: ``{order: {"candidates": int32[C, order], "points":
        [C, order + 2, 2], "loss": [C], "valid": [C]}}`` for each order
        with candidates (valid is float in soft logic, bool in hard).
    """
    if solver not in ("image", "fermat", "mpt"):
        msg = f"unknown solver {solver!r}"
        raise ValueError(msg)
    dev = resolve_device(device)
    scene = scene.to(dev)
    if approx is None:
        approx = bool(logic.ENABLE_APPROX)
    function = unchecked(function)
    groups = unchecked(path_candidate_matrices)(
        scene.num_objects, min_order=min_order, max_order=max_order, order=order,
        filter_nodes=_filter_nodes(scene, filter_objects),
    )
    spec = EagerSpec(
        groups=make_groups(groups, dev), approx=bool(approx), function=function,
        solver=solver, steps=int(steps), many=int(many),
        keys=None if key is None else group_keys(groups, prng.as_key(key)), kinds=scene.kinds,
    )
    arrays = scene_arrays(scene)
    ends = [torch.as_tensor(p).to(device=dev, dtype=torch.float32).reshape(1, 1, 2)
            for p in (tx, rx)]
    out = {}
    for k, (o, cand) in enumerate(spec.groups):
        if cand.shape[0] == 0:
            continue
        pts, loss, valid = _trace_group(
            *ends, arrays, o, cand, approx=spec.approx, alpha=alpha, function=function,
            tol=tol, patch=patch, solve=None if spec.solves is None else spec.solves[k],
        )
        out[o] = {"candidates": cand.to(torch.int32), "points": pts[0], "loss": loss[0],
                  "valid": valid[0]}
    return out
