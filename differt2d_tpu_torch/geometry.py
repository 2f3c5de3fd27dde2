"""Geometric objects and path solvers (counterpart of :mod:`differt2d_tpu.geometry`).

Objects are frozen dataclasses of tensors: values, not modules, owning no
parameters.  Their methods run the port's batched primitives
(:mod:`differt2d_tpu_torch.ops.geometry_ops`) and soft logic
(:mod:`differt2d_tpu_torch.logic`), so autograd, ``torch.func.grad``,
``jvp`` and ``vmap`` all see through them.

A field given as a tensor is kept as it is (its device, its autograd
history); one given as a number or array-like becomes a float32 tensor on
the device of the object's tensor fields, or on ``"cuda"`` when it has
none.  :func:`from_numpy` builds an object from NumPy arrays on a chosen
device (for example the arrays of the JAX package's object of the same
name).

``kind`` (a class attribute: :data:`~differt2d_tpu_torch.defaults.KIND_WALL`,
``KIND_RIS`` or ``KIND_VERTEX``) is the object's row kind in a
:class:`~differt2d_tpu_torch.scene.Scene`'s dense tensors.
"""

from __future__ import annotations

__all__ = (
    "FermatPath",
    "ImagePath",
    "MinPath",
    "Path",
    "Point",
    "RIS",
    "Ray",
    "Vertex",
    "Wall",
    "closest_point",
    "from_numpy",
    "normalize",
    "parametric_to_cartesian",
    "parametric_to_cartesian_from_slice",
    "path_length",
    "segments_intersect",
    "stack_leaves",
    "unstack_leaves",
)

import dataclasses
import math
from typing import Any, ClassVar, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ._runtime_typing import (
    FLOAT_ARRAY,
    KEY_ARRAY,
    OPT_BOOL,
    OPT_KEY_ARRAY,
    SCALAR_FLOAT,
    XY_ARRAY,
    Spec,
    typecheck,
    unchecked,
)
from ._tree import tree_flatten, tree_unflatten
from .abc import Interactable, Object, Plottable
from .defaults import (
    DEFAULT_DEVICE,
    DEFAULT_PATCH,
    KIND_RIS,
    KIND_VERTEX,
    KIND_WALL,
    resolve_device,
)
# The objects' methods run per path and per operation: they call the
# undecorated bodies of the logic functions.
from .logic import _false_value as false_value
from .logic import _greater_equal as greater_equal
from .logic import _less as less
from .logic import _less_equal as less_equal
from .logic import _logical_all as logical_all
from .logic import _logical_and as logical_and
from .logic import _logical_not as logical_not
from .logic import _logical_or as logical_or
from .logic import _true_value as true_value
from .ops import geometry_ops as _ops
from .optimize import minimize_many_random_uniform

# Values of fields left as None (``differt2d_tpu.geometry``'s defaults).
_DEFAULTS = {
    "xy": (0.0, 0.0),
    "xys": ((0.0, 0.0), (1.0, 1.0)),
    "phi": math.pi / 4,
    "loss": 0.0,
}


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a NumPy array on the host, for plotting."""
    return t.detach().cpu().numpy()


def _f32(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32)).to(device)


class _Tensors:
    """Converts an object's fields to tensors after ``__init__``."""

    def __post_init__(self):
        fields = dataclasses.fields(self)
        device = next(
            (getattr(self, f.name).device for f in fields
             if isinstance(getattr(self, f.name), torch.Tensor)),
            None,
        )
        for f in fields:
            value = getattr(self, f.name)
            if value is None:
                value = _DEFAULTS[f.name]
            if not isinstance(value, torch.Tensor):
                if device is None:
                    device = resolve_device(DEFAULT_DEVICE)
                object.__setattr__(self, f.name, _f32(value, device))


def stack_leaves(pytrees: Iterable, axis: int = 0):
    """Stack objects (or nested tuples, lists and dicts of them) of one
    structure into one batched object (``differt2d_tpu.geometry.stack_leaves``)."""
    flat = [tree_flatten(t) for t in pytrees]
    spec = flat[0][1]
    leaves = [torch.stack(xs, dim=axis) for xs in zip(*(lv for lv, _ in flat))]
    return tree_unflatten(spec, leaves)


def unstack_leaves(pytrees) -> list:
    """Split a stacked object along its first axis into a list."""
    leaves, spec = tree_flatten(pytrees)
    return [tree_unflatten(spec, list(row)) for row in zip(*(t.unbind(0) for t in leaves))]


@typecheck(P1=XY_ARRAY, P2=XY_ARRAY, P3=XY_ARRAY, P4=XY_ARRAY, tol=SCALAR_FLOAT, approx=OPT_BOOL)
def segments_intersect(P1: torch.Tensor, P2: torch.Tensor, P3: torch.Tensor,  # noqa: N803
                       P4: torch.Tensor, tol=0.005, approx: Optional[bool] = None,  # noqa: N803
                       **kwargs: Any) -> torch.Tensor:
    """Soft/hard test whether segments ``P1-P2`` and ``P3-P4`` intersect
    (``differt2d_tpu.geometry.segments_intersect``): the batched
    :func:`~differt2d_tpu_torch.ops.geometry_ops.segments_intersect`,
    checked."""
    return _ops.segments_intersect(P1, P2, P3, P4, tol=tol, approx=approx, **kwargs)


@typecheck(points=XY_ARRAY)
def path_length(points: torch.Tensor) -> torch.Tensor:
    """Length of the polyline ``points[..., N, 2]``, with a finite gradient
    where two points coincide (``differt2d_tpu.geometry.path_length``).

    >>> pts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 0.0]])
    >>> round(float(path_length(pts)), 4)  # 1 + 1 + sqrt(2)
    3.4142
    """
    return _ops.path_length(points)


@typecheck(vector=FLOAT_ARRAY)
def normalize(vector: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit vector and length over the last axis, zero-safe
    (``differt2d_tpu.geometry.normalize``).

    >>> v, length = normalize(torch.tensor([3.0, 4.0]))
    >>> float(length), [round(float(x), 4) for x in v]
    (5.0, [0.6, 0.8])
    >>> float(normalize(torch.zeros(2))[1])  # zero vector: length 1 by guard
    1.0
    """
    return _ops.normalize(vector)


@typecheck(points=XY_ARRAY, target=FLOAT_ARRAY)
def closest_point(points: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Index of and distance to the point of ``points[N, 2]`` closest to
    ``target``."""
    distances = torch.linalg.norm(points - target.reshape(-1, 2), dim=1)
    i_min = torch.argmin(distances)
    return i_min, distances[i_min]


@dataclasses.dataclass(frozen=True, eq=False)
class Point(_Tensors, Plottable):
    """A point given by its cartesian coordinates ``xy[2]``."""

    xy: torch.Tensor = None

    def plot(self, ax, *args: Any, annotate: Optional[str] = None,
             annotate_offset: tuple[float, float] = (0.0, 0.0),
             annotate_kwargs: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        """A marker (``ax.scatter``; red circle by default), and the text
        ``annotate`` offset by ``annotate_offset`` (``ax.annotate``)."""
        kwargs.setdefault("marker", "o")
        kwargs.setdefault("color", "red")
        xy = _host(self.xy)
        x, y = xy.tolist()
        artists = [ax.scatter(x, y, *args, **kwargs)]
        if annotate:
            xytext = xy + np.asarray(annotate_offset, dtype=np.float32)
            artists.append(ax.annotate(annotate, xy=(x, y), xytext=tuple(xytext.tolist()),
                                       **(annotate_kwargs or {})))
        return artists

    def bounding_box(self) -> torch.Tensor:
        return torch.stack([self.xy, self.xy])


@dataclasses.dataclass(frozen=True, eq=False)
class Vertex(Point, Object):
    """A corner for diffraction: no parameter, always contained, never
    blocking, zero interaction residual."""

    kind: ClassVar[int] = KIND_VERTEX

    @staticmethod
    def parameters_count() -> int:
        return 0

    def parametric_to_cartesian(self, param_coords: torch.Tensor) -> torch.Tensor:
        return self.xy

    def cartesian_to_parametric(self, carte_coords: torch.Tensor) -> torch.Tensor:
        return carte_coords.new_empty(0)

    def contains_parametric(self, param_coords, approx: Optional[bool] = None, **kwargs: Any):
        return true_value(approx, device=self.xy.device)

    def intersects_cartesian(self, ray, patch=DEFAULT_PATCH, approx: Optional[bool] = None,
                             **kwargs: Any):
        return false_value(approx, device=self.xy.device)

    def evaluate_cartesian(self, ray_path: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=ray_path.dtype, device=ray_path.device)

    def plot(self, ax, *args: Any, **kwargs: Any):
        """A point with a dashed black edge on a translucent yellow face."""
        kwargs.setdefault("edgecolors", "black")
        kwargs.setdefault("facecolors", (1.0, 1.0, 0.0, 0.5))
        kwargs.setdefault("linestyle", "dashed")
        return super().plot(ax, *args, **kwargs)


@dataclasses.dataclass(frozen=True, eq=False)
class Ray(_Tensors, Plottable):
    """An origin-destination segment ``xys[2, 2]``."""

    xys: torch.Tensor = None

    def origin(self) -> torch.Tensor:
        return self.xys[0, :]

    def dest(self) -> torch.Tensor:
        return self.xys[1, :]

    def t(self) -> torch.Tensor:
        """Direction vector (dest - origin)."""
        return self.dest() - self.origin()

    def rotate(self, angle, around: Optional[Union[torch.Tensor, Point]] = None):
        """Copy rotated by ``angle`` around ``around`` (a point or
        coordinates; the origin by default)."""
        xys = self.xys
        if around is None:
            center = torch.zeros(2, dtype=xys.dtype, device=xys.device)
        else:
            center = around.xy if isinstance(around, Point) else torch.as_tensor(around)
        angle = torch.as_tensor(angle, dtype=xys.dtype, device=xys.device)
        c, s = torch.cos(angle), torch.sin(angle)
        rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        rotated = (rot @ (xys - center[None, :]).T).T + center[None, :]
        return dataclasses.replace(self, xys=rotated)

    def plot(self, ax, *args: Any, **kwargs: Any):
        """The segment as a line (``ax.plot``; blue by default)."""
        kwargs.setdefault("color", "blue")
        x, y = _host(self.xys).T
        return ax.plot(x, y, *args, **kwargs)

    def bounding_box(self) -> torch.Tensor:
        return torch.stack([torch.amin(self.xys, dim=0), torch.amax(self.xys, dim=0)])


@dataclasses.dataclass(frozen=True, eq=False)
class Wall(Ray, Object):
    """A mirror wall with one parametric coordinate ``t`` in ``[0, 1]``."""

    kind: ClassVar[int] = KIND_WALL

    def normal(self) -> torch.Tensor:
        """Unit normal: the direction rotated by -90 degrees."""
        return _ops.wall_normal(self.xys)

    @staticmethod
    def parameters_count() -> int:
        return 1

    def parametric_to_cartesian(self, param_coords: torch.Tensor) -> torch.Tensor:
        return self.origin() + param_coords * self.t()

    def cartesian_to_parametric(self, carte_coords: torch.Tensor) -> torch.Tensor:
        return _ops.cartesian_to_parametric(self.xys, carte_coords).reshape(-1)

    def contains_parametric(self, param_coords, approx: Optional[bool] = None, **kwargs: Any):
        t = param_coords[0]
        ge = greater_equal(t, 0.0, approx=approx, **kwargs)
        le = less_equal(t, 1.0, approx=approx, **kwargs)
        return logical_and(ge, le, approx=approx)

    def intersects_cartesian(self, ray, patch=DEFAULT_PATCH, approx: Optional[bool] = None,
                             **kwargs: Any):
        return _ops.segments_intersect(
            self.origin() - patch * self.t(),
            self.dest() + patch * self.t(),
            ray[0, :],
            ray[1, :],
            approx=approx,
            **kwargs,
        )

    def evaluate_cartesian(self, ray_path: torch.Tensor) -> torch.Tensor:
        return _ops.specular_residual(ray_path[0, :], ray_path[1, :], ray_path[2, :], self.xys)

    def image_of(self, point: torch.Tensor) -> torch.Tensor:
        """Mirror image of ``point`` across this wall."""
        return _ops.mirror_point(point, self.xys)

    def get_vertices(self) -> tuple[Vertex, Vertex]:
        """The wall's two end vertices."""
        return Vertex(xy=self.xys[0, :]), Vertex(xy=self.xys[1, :])


@dataclasses.dataclass(frozen=True, eq=False)
class RIS(Wall):
    """Reconfigurable intelligent surface: a wall reflecting at the constant
    angle ``phi`` (pi/4 by default)."""

    kind: ClassVar[int] = KIND_RIS

    phi: torch.Tensor = None

    def evaluate_cartesian(self, ray_path: torch.Tensor) -> torch.Tensor:
        return _ops.ris_residual(ray_path[1, :], ray_path[2, :], self.xys, self.phi)

    def plot(self, ax, *args: Any, **kwargs: Any):
        """The surface as a green line."""
        kwargs.setdefault("color", "green")
        return super().plot(ax, *args, **kwargs)


def _as_xy(point) -> torch.Tensor:
    return point.xy if isinstance(point, Point) else point


# ``tx`` and ``rx`` of the solvers: a float ``[..., 2]`` tensor or a Point.
_POINT_LIKE = Spec(
    "Union[Float[Tensor, '... 2'], Point]",
    predicate=lambda v: isinstance(v, Point) or XY_ARRAY._ok(v),
)


@dataclasses.dataclass(frozen=True, eq=False)
class Path(_Tensors, Plottable):
    """A ray path ``xys[n + 2, 2]`` (transmitter, bounces, receiver) and its
    solver loss."""

    xys: torch.Tensor
    loss: torch.Tensor = None

    @classmethod
    @typecheck(tx=_POINT_LIKE, rx=_POINT_LIKE, key=OPT_KEY_ARRAY)
    def from_tx_objects_rx(cls, tx, objects: Sequence[Interactable], rx, *, key=None,
                           **kwargs: Any) -> "Path":
        """Path through the middle (``t = 0.5``) of every object."""
        tx, rx = _as_xy(tx), _as_xy(rx)
        half = torch.full((1,), 0.5, dtype=tx.dtype, device=tx.device)
        return cls(xys=torch.stack([tx, *(o.parametric_to_cartesian(half) for o in objects), rx]))

    def length(self) -> torch.Tensor:
        return _ops.path_length(self.xys)

    def on_objects(self, objects: Sequence[Interactable], approx: Optional[bool] = None,
                   **kwargs: Any):
        """Soft AND over "bounce point i lies on object i"."""
        contains = true_value(approx, device=self.xys.device)
        for i, obj in enumerate(objects):
            param_coords = obj.cartesian_to_parametric(self.xys[i + 1, :])
            contains = logical_and(
                contains, obj.contains_parametric(param_coords, approx=approx, **kwargs),
                approx=approx,
            )
        return contains

    def intersects_with_objects(self, objects: Sequence[Interactable], path_candidate,
                                patch=DEFAULT_PATCH, approx: Optional[bool] = None,
                                **kwargs: Any):
        """Soft OR over "a segment is blocked by an object it does not touch":
        each segment is tested against every object except the two it
        joins (host indices, so skipped tests are never formed)."""
        cand = np.asarray(
            path_candidate.tolist() if isinstance(path_candidate, torch.Tensor) else path_candidate
        ).reshape(-1)
        interacting = [-1, *(int(i) for i in cand), -1]
        intersects = false_value(approx, device=self.xys.device)
        for i in range(self.xys.shape[0] - 1):
            ray_path = self.xys[i : i + 2, :]
            for j, obj in enumerate(objects):
                if j in (interacting[i], interacting[i + 1]):
                    continue
                intersects = logical_or(
                    intersects,
                    obj.intersects_cartesian(ray_path, patch=patch, approx=approx, **kwargs),
                    approx=approx,
                )
        return intersects

    def is_valid(self, objects: Sequence[Interactable], path_candidate,
                 interacting_objects: Sequence[Interactable], tol=1e-2, patch=DEFAULT_PATCH,
                 approx: Optional[bool] = None, **kwargs: Any):
        """On its objects, not blocked and of loss below ``tol``; NaN counts
        as invalid (0)."""
        valid = logical_all(
            self.on_objects(interacting_objects, approx=approx, **kwargs),
            logical_not(
                self.intersects_with_objects(objects, path_candidate, patch=patch,
                                             approx=approx, **kwargs),
                approx=approx,
            ),
            less(self.loss, tol, approx=approx, **kwargs),
            approx=approx,
        )
        return torch.nan_to_num(valid) if valid.is_floating_point() else valid

    def plot(self, ax, *args: Any, **kwargs: Any):
        """The path as a polyline (``ax.plot``; orange by default)."""
        kwargs.setdefault("color", "orange")
        x, y = _host(self.xys).T
        return ax.plot(x, y, *args, **kwargs)

    def bounding_box(self) -> torch.Tensor:
        return torch.stack([torch.amin(self.xys, dim=0), torch.amax(self.xys, dim=0)])


def parametric_to_cartesian_from_slice(obj: Interactable, parametric_coords: torch.Tensor,
                                       start: int, size: int) -> torch.Tensor:
    """Map the ``size`` parameters of ``obj`` at ``start`` of the packed
    vector to cartesian coordinates."""
    return obj.parametric_to_cartesian(parametric_coords[start : start + size])


def parametric_to_cartesian(objects: Sequence[Interactable], parametric_coords: torch.Tensor,
                            n: int, tx_coords: torch.Tensor, rx_coords: torch.Tensor):
    """``[n + 2, 2]``: transmitter, the bounce of each object from the
    packed parameter vector, receiver."""
    points, j = [tx_coords], 0
    for obj in objects:
        size = obj.parameters_count()
        points.append(parametric_to_cartesian_from_slice(obj, parametric_coords, j, size))
        j += size
    points.append(rx_coords)
    return torch.stack(points)


def _interaction_loss(objects: Sequence[Interactable], cartesian_coords: torch.Tensor):
    """Sum of the objects' interaction residuals along a path."""
    loss = torch.zeros((), dtype=cartesian_coords.dtype, device=cartesian_coords.device)
    for i, obj in enumerate(objects):
        loss = loss + obj.evaluate_cartesian(cartesian_coords[i : i + 3, :])
    return loss


def _empty_path(cls, tx, rx):
    return cls(xys=torch.stack([tx, rx]), loss=torch.zeros((), dtype=tx.dtype, device=tx.device))


@dataclasses.dataclass(frozen=True, eq=False)
class ImagePath(Path):
    """Path of the image method: mirror the transmitter through each wall,
    then intersect each image-to-target line with its wall, from the
    receiver back.  The loss is the interaction residual."""

    @classmethod
    @typecheck(tx=_POINT_LIKE, rx=_POINT_LIKE, key=OPT_KEY_ARRAY)
    def from_tx_objects_rx(cls, tx, objects: Sequence[Wall], rx, *, key=None,
                           **kwargs: Any) -> "ImagePath":
        tx, rx = _as_xy(tx), _as_xy(rx)
        n = len(objects)
        if n == 0:
            return _empty_path(cls, tx, rx)
        images, image = [], tx
        for obj in objects:
            image = obj.image_of(image)
            images.append(image)
        # un == 0 (line parallel to the wall) leaves the point where it is.
        point, points = rx, [None] * n
        for i in range(n - 1, -1, -1):
            wall = objects[i]
            normal = wall.normal()
            u = point - images[i]
            v = wall.origin() - point
            un = torch.sum(u * normal, dim=-1)
            vn = torch.sum(v * normal, dim=-1)
            parallel = un == 0.0
            inc = torch.where(parallel, 0.0, vn * u / torch.where(parallel, 1.0, un))
            point = point + inc
            points[i] = point
        xys = torch.stack([tx, *points, rx])
        return cls(xys=xys, loss=_interaction_loss(objects, xys))


def _solve(objects, tx, rx, objective, key, kwargs):
    """``(xys, last_loss)`` of the adam solve of ``objective`` over the
    packed parameters of ``objects``, from ``key``'s uniform draw."""
    n = len(objects)
    n_unknowns = sum(obj.parameters_count() for obj in objects)

    # Differentiable data (the ends and the objects) rides in ``args`` so
    # that minimize(implicit=True) differentiates with respect to it.
    def loss_fun(theta, p):
        tx_, rx_, objs = p
        return objective(objs, parametric_to_cartesian(objs, theta, n, tx_, rx_))

    kwargs.setdefault("many", 1)
    theta, loss = unchecked(minimize_many_random_uniform)(
        loss_fun, key, n_unknowns, args=((tx, rx, tuple(objects)),), device=tx.device,
        **kwargs,
    )
    return parametric_to_cartesian(objects, theta, n, tx, rx), loss


@dataclasses.dataclass(frozen=True, eq=False)
class FermatPath(Path):
    """Path of least length (Fermat's principle), by adam over the packed
    parameters; the loss is the interaction residual of the path found.
    ``kwargs`` go to :func:`~differt2d_tpu_torch.optimize.minimize_many_random_uniform`
    (``steps``, ``many``, ``implicit``)."""

    @classmethod
    @typecheck(tx=_POINT_LIKE, rx=_POINT_LIKE, key=KEY_ARRAY)
    def from_tx_objects_rx(cls, tx, objects: Sequence[Interactable], rx, *, key,
                           **kwargs: Any) -> "FermatPath":
        tx, rx = _as_xy(tx), _as_xy(rx)
        if not objects:
            return _empty_path(cls, tx, rx)
        xys, _ = _solve(objects, tx, rx, lambda objs, xys: _ops.path_length(xys), key, kwargs)
        return cls(xys=xys, loss=_interaction_loss(objects, xys))


@dataclasses.dataclass(frozen=True, eq=False)
class MinPath(Path):
    """Path of Min-Path-Tracing: adam over the packed parameters on the sum
    of the interaction residuals (right for diffraction and RIS, where
    length is the wrong objective); the loss is the solve's last loss."""

    @classmethod
    @typecheck(tx=_POINT_LIKE, rx=_POINT_LIKE, key=KEY_ARRAY)
    def from_tx_objects_rx(cls, tx, objects: Sequence[Interactable], rx, *, key,
                           **kwargs: Any) -> "MinPath":
        tx, rx = _as_xy(tx), _as_xy(rx)
        if not objects:
            return _empty_path(cls, tx, rx)
        xys, loss = _solve(objects, tx, rx, _interaction_loss, key, kwargs)
        return cls(xys=xys, loss=loss)


_CLASSES = {cls.__name__: cls for cls in (
    Point, Vertex, Ray, Wall, RIS, Path, ImagePath, FermatPath, MinPath)}


def from_numpy(name: str, *, device=DEFAULT_DEVICE, **arrays) -> Any:
    """The object of class ``name`` (``"Point"``, ``"Wall"``, ``"RIS"``, ...)
    whose fields are the NumPy arrays ``arrays``, as float32 tensors on
    ``device``: for example the arrays of the JAX package's object of that
    name, ``{f.name: np.asarray(getattr(obj, f.name)) for f in
    dataclasses.fields(obj)}``."""
    if name not in _CLASSES:
        msg = f"unknown object class {name!r}; one of {sorted(_CLASSES)}"
        raise ValueError(msg)
    dev = resolve_device(device)
    return _CLASSES[name](**{k: _f32(v, dev) for k, v in arrays.items()})
