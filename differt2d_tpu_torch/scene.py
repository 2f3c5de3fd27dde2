"""Scenes as dense tensors, with the object API of :mod:`differt2d_tpu.scene`.

A :class:`Scene` holds every object as a segment ``walls[W, 2, 2]`` with a
per-object ``kind`` (wall, RIS or vertex; a vertex stores its location in
both endpoints) and RIS phase ``phi``, plus named transmitter and receiver
points.  The kinds are also kept on the host as a tuple: they are the
scene's structure (which candidates exist, which kernel serves them) and
reading them never waits for the device.  ``power_map`` and the kernels
read those tensors.

The JAX package's object view sits on top: :attr:`Scene.objects` gives
:class:`~differt2d_tpu_torch.geometry.Wall`, ``RIS`` and ``Vertex`` views of
the rows (indexing the device tensors, no copy), and the scene algebra
(``with_*``, ``update_*``, ``add_objects``, ``filter_objects``,
``rename_*``), the factories, the path generators (``all_paths``, with
keys split sequentially per path) and the accumulators (``accumulate_over_paths``
and the grid accumulators, which send ``received_power`` requests to
:func:`~differt2d_tpu_torch.tracer.power_map` and its kernels) work on it.
Transmitters and receivers are stored as ``xy`` tensors and handed to user
code as :class:`~differt2d_tpu_torch.geometry.Point` views.  A scene is a
frozen value: every derivation returns a new one, its dicts copied (the
JAX package's ``PyTreeDict`` is JAX plumbing and has no counterpart).

The city scenes read GeoJSON building footprints
(:meth:`Scene.from_geojson`); :meth:`Scene.city_extract_scene` reads the
package's own copy of the JAX package's extract,
``differt2d_tpu_torch/data/city_extract.geojson``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from itertools import product
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from . import prng, tracer
from .abc import Plottable
from .defaults import (
    DEFAULT_DEVICE,
    KIND_RIS,
    KIND_VERTEX,
    KIND_WALL,
    resolve_device,
)
from .geometry import (
    RIS,
    FermatPath,
    ImagePath,
    MinPath,
    Point,
    Vertex,
    Wall,
    closest_point,
    stack_leaves,
    unstack_leaves,
)
from .logic import is_true
from .rt import path_candidate_matrices
from .utils import received_power

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

SCENE_NAMES = (
    "basic_scene",
    "city_extract_scene",
    "city_scene",
    "square_scene",
    "square_scene_with_obstacle",
    "square_scene_with_wall",
)
"""Names of the scene factories (:meth:`Scene.from_scene_name`)."""

def _f32(x, device) -> torch.Tensor:
    """Copy ``x`` (array-like or tensor) into a float32 tensor on ``device``.

    NumPy inputs are copied first: ``np.asarray`` of a JAX array is
    read-only, and ``torch.from_numpy`` warns on read-only arrays.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    arr = np.array(x, dtype=np.float32, copy=True)
    return torch.from_numpy(arr).to(device)


def _xy(point, device) -> torch.Tensor:
    """A point (:class:`Point`, tensor or array-like) as float32 ``xy[2]``
    on ``device``; tensors keep their autograd history."""
    return _f32(point.xy if isinstance(point, Point) else point, device).reshape(2)


def _object_rows(objects, device) -> tuple:
    """``(walls[W, 2, 2], kind[W], phi[W], kinds)`` of geometry objects, by
    ``torch.stack`` (autograd sees through it)."""
    rows, phis, kinds = [], [], []
    for obj in objects:
        if isinstance(obj, Vertex):
            xy = _xy(obj.xy, device)
            rows.append(torch.stack([xy, xy]))
        elif isinstance(obj, Wall):
            rows.append(_f32(obj.xys, device).reshape(2, 2))
        else:
            msg = f"a scene holds Wall, RIS and Vertex objects, got {type(obj).__name__}"
            raise TypeError(msg)
        phis.append(_f32(obj.phi, device).reshape(()) if isinstance(obj, RIS)
                    else torch.zeros((), device=device))
        kinds.append(obj.kind)
    if not rows:
        return (torch.zeros(0, 2, 2, device=device), torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(0, device=device), ())
    kind = torch.tensor(kinds, dtype=torch.int32, device=device)
    return torch.stack(rows), kind, torch.stack(phis), tuple(kinds)


@dataclasses.dataclass(frozen=True, eq=False)
class Scene(Plottable):
    """Walls, kinds, RIS phases and named TX/RX points, all on one device.

    Treat a scene as immutable: derive a new one (:meth:`replace`,
    :meth:`with_objects`, :meth:`update_transmitters`, :meth:`add_ris`,
    ...) instead of writing into its tensors, so that its host-side
    ``kinds`` stay true.
    """

    walls: torch.Tensor
    kind: torch.Tensor
    phi: torch.Tensor
    transmitters: Mapping[str, torch.Tensor]
    receivers: Mapping[str, torch.Tensor]
    kinds: tuple = dataclasses.field(default=None)

    def __post_init__(self):
        if self.walls.dim() != 3 or tuple(self.walls.shape[1:]) != (2, 2):
            msg = f"walls must be [W, 2, 2], got {tuple(self.walls.shape)}"
            raise ValueError(msg)
        W = self.walls.shape[0]
        if tuple(self.kind.shape) != (W,) or tuple(self.phi.shape) != (W,):
            msg = "kind and phi must be [W] like walls"
            raise ValueError(msg)
        if self.kinds is None:
            object.__setattr__(
                self, "kinds", tuple(int(k) for k in self.kind.tolist())
            )
        if any(k not in (KIND_WALL, KIND_RIS, KIND_VERTEX) for k in self.kinds):
            msg = f"unknown object kind in {self.kinds}"
            raise ValueError(msg)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        walls,
        kind=None,
        phi=None,
        transmitters: Optional[Mapping] = None,
        receivers: Optional[Mapping] = None,
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Scene from array-likes or tensors (copied to ``device``); the
        points may also be :class:`Point` objects."""
        dev = resolve_device(device)
        walls_t = _f32(walls, dev).reshape(-1, 2, 2)
        W = walls_t.shape[0]
        if kind is None:
            kinds = (KIND_WALL,) * W
        elif isinstance(kind, torch.Tensor):
            kinds = tuple(int(k) for k in kind.tolist())
        else:
            kinds = tuple(int(k) for k in np.asarray(kind).reshape(-1))
        kind_t = torch.tensor(kinds, dtype=torch.int32, device=dev).reshape(W)
        phi_t = _f32(np.zeros(W) if phi is None else phi, dev).reshape(W)
        return cls(
            walls=walls_t,
            kind=kind_t,
            phi=phi_t,
            transmitters={k: _xy(v, dev) for k, v in (transmitters or {}).items()},
            receivers={k: _xy(v, dev) for k, v in (receivers or {}).items()},
            kinds=kinds,
        )

    @classmethod
    def from_walls_array(cls, walls, *, device=DEFAULT_DEVICE) -> "Scene":
        """Empty scene (no TX/RX) from a ``[num_walls, 2, 2]`` array."""
        return cls.from_arrays(walls, device=device)

    @classmethod
    def basic_scene(
        cls,
        tx_coords=(0.1, 0.1),
        rx_coords=(0.302, 0.2147),
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Unit square with an inner room in the lower-left corner; 7 walls
        (same layout as ``differt2d_tpu.scene.Scene.basic_scene``)."""
        walls = [
            # Outer walls.
            [[0.0, 0.0], [1.0, 0.0]],
            [[1.0, 0.0], [1.0, 1.0]],
            [[1.0, 1.0], [0.0, 1.0]],
            [[0.0, 1.0], [0.0, 0.0]],
            # Inner room with entrance.
            [[0.4, 0.0], [0.4, 0.4]],
            [[0.4, 0.4], [0.3, 0.4]],
            [[0.1, 0.4], [0.0, 0.4]],
        ]
        return cls.from_arrays(
            walls,
            transmitters={"tx": tx_coords},
            receivers={"rx": rx_coords},
            device=device,
        )

    @classmethod
    def square_scene(
        cls,
        tx_coords=(0.2, 0.2),
        rx_coords=(0.5, 0.6),
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Unit square, 4 walls."""
        walls = [
            [[0.0, 0.0], [1.0, 0.0]],
            [[1.0, 0.0], [1.0, 1.0]],
            [[1.0, 1.0], [0.0, 1.0]],
            [[0.0, 1.0], [0.0, 0.0]],
        ]
        return cls.from_arrays(
            walls,
            transmitters={"tx": tx_coords},
            receivers={"rx": rx_coords},
            device=device,
        )

    @classmethod
    def square_scene_with_wall(
        cls,
        ratio: float = 0.6,
        tx_coords=(0.2, 0.5),
        rx_coords=(0.8, 0.5),
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Square scene plus a central vertical wall of ``ratio`` of the
        side (``differt2d_tpu.scene.Scene.square_scene_with_wall``)."""
        scene = cls.square_scene(tx_coords=tx_coords, rx_coords=rx_coords, device=device)
        xys = [[0.5, 0.5 * (1 - ratio)], [0.5, 0.5 * (1 + ratio)]]
        return scene.add_objects(Wall(xys=_f32(xys, scene.device)))

    @classmethod
    def square_scene_with_obstacle(
        cls, ratio: float = 0.1, *, device=DEFAULT_DEVICE, **kwargs: Any
    ) -> "Scene":
        """Square scene plus a central square obstacle of side ``ratio``
        (``differt2d_tpu.scene.Scene.square_scene_with_obstacle``)."""
        scene = cls.square_scene(device=device, **kwargs)
        hl = 0.5 * ratio
        x0, x1 = 0.5 - hl, 0.5 + hl
        y0, y1 = 0.5 - hl, 0.5 + hl
        rings = ([[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]], [[x1, y1], [x0, y1]],
                 [[x0, y1], [x0, y0]])
        return scene.add_objects(*(Wall(xys=_f32(xys, scene.device)) for xys in rings))

    @classmethod
    def random_uniform_scene(
        cls,
        n_transmitters: int = 1,
        n_walls: int = 1,
        n_receivers: int = 1,
        *,
        key,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Scene of uniform random points in the unit square, from one draw
        ``prng.uniform(key, (n_tx + 2 n_walls + n_rx, 2))``: the
        transmitters ``tx_i`` first, then the walls' ends, the receivers
        ``rx_i`` from the end (``differt2d_tpu.scene.Scene.random_uniform_scene``,
        bit for bit)."""
        n_tx, n_w, n_rx = int(n_transmitters), int(n_walls), int(n_receivers)
        points = _f32(prng.uniform(key, (n_tx + 2 * n_w + n_rx, 2)), resolve_device(device))
        return cls.from_objects(
            [Wall(xys=points[2 * i + n_tx : 2 * i + 2 + n_tx, :]) for i in range(n_w)],
            transmitters={f"tx_{i}": points[i, :] for i in range(n_tx)},
            receivers={f"rx_{i}": points[-(i + 1), :] for i in range(n_rx)},
            device=device,
        )

    @classmethod
    def from_scene_name(cls, scene_name: str, *args: Any, **kwargs: Any) -> "Scene":
        """The scene of the factory named ``scene_name`` (one of
        :data:`SCENE_NAMES`)."""
        if scene_name not in SCENE_NAMES:
            msg = f"scene_name must be one of {SCENE_NAMES}, got {scene_name!r}"
            raise ValueError(msg)
        return getattr(cls, scene_name)(*args, **kwargs)

    @classmethod
    def from_objects(
        cls,
        objects: Sequence = (),
        transmitters: Optional[Mapping] = None,
        receivers: Optional[Mapping] = None,
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Scene of geometry objects (``Wall``, ``RIS``, ``Vertex``) and named
        points (``Point`` objects, tensors or array-likes), on ``device``."""
        dev = resolve_device(device)
        walls, kind, phi, kinds = _object_rows(objects, dev)
        return cls(
            walls=walls, kind=kind, phi=phi,
            transmitters={k: _xy(v, dev) for k, v in (transmitters or {}).items()},
            receivers={k: _xy(v, dev) for k, v in (receivers or {}).items()},
            kinds=kinds,
        )

    @classmethod
    def from_stacked_objects(cls, objects) -> "Scene":
        """Scene (no points) of the objects of a stacked object
        (:meth:`stacked_objects`), on its device."""
        rows = unstack_leaves(objects)
        device = rows[0].bounding_box().device if rows else resolve_device(DEFAULT_DEVICE)
        return cls.from_objects(rows, device=device)

    @classmethod
    def from_geojson(
        cls, s_or_fp, tx_loc: str = "NW", rx_loc: str = "SE", *, device=DEFAULT_DEVICE
    ) -> "Scene":
        """Scene from a GeoJSON string, bytes or file-like: one wall per edge
        of each polygon's outer ring (the first edge closes the ring), TX and
        RX at compass anchors of the walls' bounding box
        (``differt2d_tpu.scene.Scene.from_geojson``)."""
        if hasattr(s_or_fp, "read"):
            return cls.from_geojson(s_or_fp.read(), tx_loc, rx_loc, device=device)
        if not isinstance(s_or_fp, (str, bytes, bytearray)):
            msg = f"Unsupported type {type(s_or_fp)}"
            raise NotImplementedError(msg)
        walls = []
        for feature in json.loads(s_or_fp).get("features", []):
            geometry = feature.get("geometry", None)
            if geometry and geometry["type"] == "Polygon":
                ring = geometry["coordinates"][0]
                walls += [[ring[i - 1], ring[i]] for i in range(len(ring))]
        if not walls:
            return cls.from_arrays(
                np.zeros((0, 2, 2), np.float32), transmitters={"tx": [0.0, 0.0]},
                receivers={"rx": [1.0, 1.0]}, device=device,
            )
        scene = cls.from_arrays(np.asarray(walls, np.float32), device=device)
        return scene.replace(
            transmitters={"tx": scene.get_location(tx_loc)},
            receivers={"rx": scene.get_location(rx_loc)},
        )

    @classmethod
    def city_extract_scene(
        cls, tx_loc: str = "NW", rx_loc: str = "SE", *, device=DEFAULT_DEVICE
    ) -> "Scene":
        """The synthetic OSM-style city extract: 23 buildings, 136 oblique
        walls (``differt2d_tpu.scene.Scene.city_extract_scene``)."""
        with open(os.path.join(_DATA_DIR, "city_extract.geojson")) as fp:
            return cls.from_geojson(fp.read(), tx_loc, rx_loc, device=device)

    @classmethod
    def city_scene(
        cls,
        blocks: tuple = (5, 6),
        street: float = 0.06,
        margin: float = 0.03,
        *,
        device=DEFAULT_DEVICE,
    ) -> "Scene":
        """Manhattan-style city: ``blocks[0] x blocks[1]`` rectangular
        buildings separated by streets in the unit square (120 walls by
        default), TX at the central street crossing and RX mid-block in
        the street east of it (``differt2d_tpu.scene.Scene.city_scene``)."""
        nx, ny = blocks
        bw = (1.0 - 2.0 * margin - (nx - 1) * street) / nx
        bh = (1.0 - 2.0 * margin - (ny - 1) * street) / ny
        if bw <= 0 or bh <= 0:
            msg = f"blocks {blocks} do not fit with street={street}"
            raise ValueError(msg)
        features = []
        for i in range(nx):
            for j in range(ny):
                x0 = margin + i * (bw + street)
                y0 = margin + j * (bh + street)
                x1, y1 = x0 + bw, y0 + bh
                ring = [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]
                features.append(
                    {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [ring]}}
                )
        scene = cls.from_geojson(
            json.dumps({"type": "FeatureCollection", "features": features}), device=device
        )
        cross_x = margin + (nx // 2) * (bw + street) - street / 2.0
        cross_y = margin + (ny // 2) * (bh + street) - street / 2.0
        rx_x = margin + (nx // 2 + 1) * (bw + street) + bw / 2.0
        return scene.replace(
            transmitters={"tx": _f32([cross_x, cross_y], scene.device)},
            receivers={"rx": _f32([rx_x, cross_y], scene.device)},
        )

    # -- derivation ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.walls.device

    @property
    def num_objects(self) -> int:
        return len(self.kinds)

    def replace(self, **changes) -> "Scene":
        """Copy with some fields replaced (``kinds`` is re-derived when
        ``kind`` changes)."""
        if "kind" in changes and "kinds" not in changes:
            changes["kinds"] = None
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Scene":
        """The same scene on ``device`` (``self`` if it is already there)."""
        dev = torch.device(device)
        if self.walls.device == dev:
            return self
        return Scene(
            walls=self.walls.to(dev),
            kind=self.kind.to(dev),
            phi=self.phi.to(dev),
            transmitters={k: v.to(dev) for k, v in self.transmitters.items()},
            receivers={k: v.to(dev) for k, v in self.receivers.items()},
            kinds=self.kinds,
        )

    def with_transmitters(self, **transmitters) -> "Scene":
        """Copy with exactly these transmitters (``name=point``: a
        :class:`Point`, a tensor or an array-like)."""
        return self.replace(transmitters={k: _xy(v, self.device) for k, v in transmitters.items()})

    def with_receivers(self, **receivers) -> "Scene":
        """Copy with exactly these receivers."""
        return self.replace(receivers={k: _xy(v, self.device) for k, v in receivers.items()})

    def update_transmitters(self, **points) -> "Scene":
        """Copy with these transmitters added or replaced."""
        return self.replace(transmitters={
            **self.transmitters, **{k: _xy(v, self.device) for k, v in points.items()}})

    def update_receivers(self, **points) -> "Scene":
        """Copy with these receivers added or replaced."""
        return self.replace(receivers={
            **self.receivers, **{k: _xy(v, self.device) for k, v in points.items()}})

    def rename_transmitters(self, **names: str) -> "Scene":
        """Copy with transmitters renamed (``old=new``), in their order."""
        return self.replace(transmitters={names.get(k, k): v for k, v in self.transmitters.items()})

    def rename_receivers(self, **names: str) -> "Scene":
        """Copy with receivers renamed (``old=new``), in their order."""
        return self.replace(receivers={names.get(k, k): v for k, v in self.receivers.items()})

    def with_objects(self, *objects) -> "Scene":
        """Copy with exactly these objects (``Wall``, ``RIS``, ``Vertex``)."""
        walls, kind, phi, kinds = _object_rows(objects, self.device)
        return self.replace(walls=walls, kind=kind, phi=phi, kinds=kinds)

    def add_objects(self, *objects) -> "Scene":
        """Copy with these objects appended."""
        walls, kind, phi, kinds = _object_rows(objects, self.device)
        return self.replace(
            walls=torch.cat([self.walls, walls]), kind=torch.cat([self.kind, kind]),
            phi=torch.cat([self.phi, phi]), kinds=self.kinds + kinds,
        )

    def filter_objects(self, filter_spec: Callable[[Any], bool]) -> "Scene":
        """Copy keeping the objects whose view passes ``filter_spec``."""
        keep = [i for i, o in enumerate(self.objects) if filter_spec(o)]
        idx = torch.tensor(keep, dtype=torch.long, device=self.device)
        return self.replace(walls=self.walls[idx], kind=self.kind[idx], phi=self.phi[idx],
                            kinds=tuple(self.kinds[i] for i in keep))

    def add_ris(self, xys, phi=math.pi / 4) -> "Scene":
        """Append a RIS segment with constant reflection angle ``phi``
        (default pi/4, as the JAX package's ``RIS``)."""
        dev = self.device
        return self.add_objects(RIS(xys=_f32(xys, dev).reshape(2, 2), phi=_f32(phi, dev)))

    def add_vertex(self, xy) -> "Scene":
        """Append a diffraction vertex (stored as a zero-length segment)."""
        return self.add_objects(Vertex(xy=_f32(xy, self.device).reshape(2)))

    def swap_ends(self) -> "Scene":
        """Transmitters become receivers and vice versa (path reversal)."""
        return self.replace(transmitters=self.receivers, receivers=self.transmitters)

    # -- the object view -----------------------------------------------------

    @functools.cached_property
    def objects(self) -> tuple:
        """A :class:`Wall`, :class:`RIS` or :class:`Vertex` view of each row
        (views of the device tensors: nothing is copied to the host)."""
        out = []
        for i, k in enumerate(self.kinds):
            if k == KIND_VERTEX:
                out.append(Vertex(xy=self.walls[i, 0]))
            elif k == KIND_RIS:
                out.append(RIS(xys=self.walls[i], phi=self.phi[i]))
            else:
                out.append(Wall(xys=self.walls[i]))
        return tuple(out)

    def get_object(self, index) -> Any:
        """The view of object ``index``."""
        return self.objects[int(index)]

    def stacked_objects(self):
        """All objects stacked into one batched object (they must be of one
        class)."""
        return stack_leaves(self.objects)

    def bounding_box(self) -> torch.Tensor:
        """``[[xmin, ymin], [xmax, ymax]]`` over walls, transmitters and
        receivers."""
        pts = [self.walls.detach().reshape(-1, 2)]
        pts += [v.detach().reshape(1, 2) for v in self.transmitters.values()]
        pts += [v.detach().reshape(1, 2) for v in self.receivers.values()]
        allp = torch.cat(pts)
        return torch.stack([allp.amin(dim=0), allp.amax(dim=0)])

    def _closest(self, points: Mapping, coords) -> tuple:
        names = list(points)
        i_min, distance = closest_point(torch.stack([points[k] for k in names]),
                                        _f32(coords, self.device))
        return names[int(i_min)], distance

    def get_closest_transmitter(self, coords) -> tuple[str, torch.Tensor]:
        """Name of the transmitter closest to ``coords``, and its distance."""
        return self._closest(self.transmitters, coords)

    def get_closest_receiver(self, coords) -> tuple[str, torch.Tensor]:
        """Name of the receiver closest to ``coords``, and its distance."""
        return self._closest(self.receivers, coords)

    # -- paths ---------------------------------------------------------------

    def all_transmitter_receiver_pairs(self) -> Iterator:
        """``((tx_name, Point), (rx_name, Point))`` for every pair, transmitters
        outermost."""
        return product(
            ((k, Point(xy=v)) for k, v in self.transmitters.items()),
            ((k, Point(xy=v)) for k, v in self.receivers.items()),
        )

    def _np_path_candidates(self, min_order: int = 0, max_order: int = 1, *,
                            order: Optional[int] = None, filter_objects=None) -> list:
        """Candidates as host rows, order-major, then lexicographic."""
        groups = path_candidate_matrices(
            self.num_objects, min_order=min_order, max_order=max_order, order=order,
            filter_nodes=tracer._filter_nodes(self, filter_objects),
        )
        return [row for o in sorted(groups) for row in groups[o]]

    def all_path_candidates(self, min_order: int = 0, max_order: int = 1, *,
                            order: Optional[int] = None, filter_objects=None) -> list:
        """Every candidate (``int32[order]`` object indices on the scene's
        device), order-major, then lexicographic; ``filter_objects`` keeps
        the objects whose view it accepts."""
        return [
            torch.from_numpy(np.array(row, dtype=np.int32)).to(self.device)
            for row in self._np_path_candidates(min_order, max_order, order=order,
                                                filter_objects=filter_objects)
        ]

    def get_interacting_objects(self, path_candidate) -> list:
        """The views of the objects a candidate passes on."""
        if isinstance(path_candidate, torch.Tensor):
            path_candidate = path_candidate.tolist()
        return [self.objects[int(i)] for i in np.asarray(path_candidate).reshape(-1)]

    def all_paths(self, path_cls: type = ImagePath, path_cls_kwargs: Optional[Mapping] = None,
                  min_order: int = 0, max_order: int = 1, order: Optional[int] = None,
                  filter_objects=None, *, key=None, **kwargs: Any) -> Iterator:
        """``(tx_name, rx_name, valid, path, candidate)`` for every pair and
        candidate; ``kwargs`` go to :meth:`Path.is_valid`.  With a key, each
        path's key comes from ``key, key_path = prng.split(key, 2)``, in
        turn over the pairs and their candidates (as the JAX package)."""
        for tx_key, rx_key, valid, path, cand in self._iter_paths(
            path_cls, path_cls_kwargs, min_order, max_order, order, filter_objects,
            key=key, **kwargs,
        ):
            yield (tx_key, rx_key, valid, path,
                   torch.from_numpy(np.array(cand, dtype=np.int32)).to(self.device))

    def _iter_paths(self, path_cls: type = ImagePath, path_cls_kwargs: Optional[Mapping] = None,
                    min_order: int = 0, max_order: int = 1, order: Optional[int] = None,
                    filter_objects=None, *, key=None, **kwargs: Any):
        """:meth:`all_paths` with host candidates."""
        path_cls_kwargs = dict(path_cls_kwargs or {})
        candidates = self._np_path_candidates(min_order, max_order, order=order,
                                              filter_objects=filter_objects)
        if key is not None:
            key = prng.as_key(key)
        for (tx_key, transmitter), (rx_key, receiver) in self.all_transmitter_receiver_pairs():
            for cand in candidates:
                interacting = self.get_interacting_objects(cand)
                key_path = None
                if key is not None:
                    key, key_path = prng.split(key, 2)
                path = path_cls.from_tx_objects_rx(transmitter, interacting, receiver,
                                                   key=key_path, **path_cls_kwargs)
                valid = path.is_valid(self.objects, cand, interacting, **kwargs)
                yield tx_key, rx_key, valid, path, cand

    def all_valid_paths(self, approx: Optional[bool] = None, **kwargs: Any) -> Iterator:
        """``(tx_name, rx_name, path, candidate)`` of the paths of
        :meth:`all_paths` that :func:`~differt2d_tpu_torch.logic.is_true`
        accepts."""
        for tx_key, rx_key, valid, path, cand in self.all_paths(approx=approx, **kwargs):
            if is_true(valid, approx=approx):
                yield tx_key, rx_key, path, cand

    # -- accumulators --------------------------------------------------------

    def accumulate_over_paths(self, fun: Callable, fun_args: tuple = (),
                              fun_kwargs: Optional[Mapping] = None, *, reduce_all: bool = False,
                              **kwargs: Any):
        """``valid * fun(transmitter, receiver, path, interacting_objects,
        *fun_args, **fun_kwargs)`` summed over the paths of each pair:
        ``(tx_name, rx_name, sum)`` per pair in the order first seen, or, with
        ``reduce_all``, the sum over all pairs.  ``kwargs`` are those of
        :meth:`all_paths`."""
        fun_kwargs = dict(fun_kwargs or {})

        def results():
            sums: dict = {}
            for tx_key, rx_key, valid, path, cand in self._iter_paths(**kwargs):
                contribution = valid * fun(
                    Point(xy=self.transmitters[tx_key]), Point(xy=self.receivers[rx_key]),
                    path, self.get_interacting_objects(cand), *fun_args, **fun_kwargs,
                )
                pair = (tx_key, rx_key)
                if pair not in sums:
                    sums[pair] = torch.zeros((), device=self.device)
                sums[pair] = sums[pair] + contribution
            for (tx_key, rx_key), total in sums.items():
                yield tx_key, rx_key, total

        if reduce_all:
            total = torch.zeros((), device=self.device)
            for _, _, p in results():
                total = total + p
            return total
        return results()

    def accumulate_on_transmitters_grid_over_paths(self, X, Y, fun: Callable,
                                                   fun_args: tuple = (),
                                                   fun_kwargs: Optional[Mapping] = None, *,
                                                   transmitter_cls: type = Point, **kwargs):
        """:meth:`accumulate_on_receivers_grid_over_paths` with the grid's
        points as the transmitters (an iterator of ``(rx_name, map)``, or
        the sum with ``reduce_all``)."""
        return self._grid_accumulate(X, Y, fun, fun_args, dict(fun_kwargs or {}),
                                     on_transmitters=True, point_cls=transmitter_cls, **kwargs)

    def accumulate_on_receivers_grid_over_paths(self, X, Y, fun: Callable,
                                                fun_args: tuple = (),
                                                fun_kwargs: Optional[Mapping] = None, *,
                                                receiver_cls: type = Point, **kwargs):
        """``fun`` accumulated over the paths to every receiver of the ``X``/``Y``
        grid, per transmitter: an iterator of ``(tx_name, map)``, or the sum
        with ``reduce_all=True``; ``[m, n, 2]`` pixel gradients with
        ``grad=True``, ``(map, gradient)`` with ``value_and_grad=True``.

        Keywords: ``reduce_all``, ``grad``, ``value_and_grad``, ``path_cls``
        (``ImagePath``), ``path_cls_kwargs``, ``min_order``, ``max_order``,
        ``order``, ``filter_objects``, ``key``, and those of
        :meth:`Path.is_valid` (``approx``, ``alpha``, ``function``, ``tol``,
        ``patch``).  A request ``power_map`` expresses (``fun`` is
        :func:`~differt2d_tpu_torch.utils.received_power` with no
        ``fun_args``, ``receiver_cls`` is :class:`Point`, a path class of the
        three solvers and only those keywords, ``r_coef``/``height`` in
        ``fun_kwargs``, ``steps``/``many`` in ``path_cls_kwargs``) runs
        :func:`~differt2d_tpu_torch.tracer.power_map` on the scene's device,
        with its kernels; any other runs the object path per pixel under
        ``torch.func.vmap`` (``torch.func.grad`` for the gradients), the
        candidates' keys from ``prng.split(key, len(candidates))``.
        """
        return self._grid_accumulate(X, Y, fun, fun_args, dict(fun_kwargs or {}),
                                     on_transmitters=False, point_cls=receiver_cls, **kwargs)

    def _grid_accumulate(self, X, Y, fun, fun_args, fun_kwargs, *, on_transmitters: bool,
                         point_cls: type, reduce_all: bool = False, grad: bool = False,
                         value_and_grad: bool = False, path_cls: type = ImagePath,
                         path_cls_kwargs: Optional[Mapping] = None, min_order: int = 0,
                         max_order: int = 1, order: Optional[int] = None, filter_objects=None,
                         key=None, **kwargs):
        path_cls_kwargs = dict(path_cls_kwargs or {})
        request = dict(reduce_all=reduce_all, grad=grad, value_and_grad=value_and_grad,
                       path_cls=path_cls, path_cls_kwargs=path_cls_kwargs, min_order=min_order,
                       max_order=max_order, order=order, filter_objects=filter_objects,
                       key=key)
        dummy = Point(xy=torch.zeros(2, device=self.device))
        scene = (self.with_transmitters(tx=dummy) if on_transmitters
                 else self.with_receivers(rx=dummy))
        if _fast_grid(fun, fun_args, fun_kwargs, point_cls, path_cls, path_cls_kwargs, kwargs):
            return scene._power_maps(X, Y, fun_kwargs, on_transmitters, request, kwargs)
        return scene._object_maps(X, Y, fun, fun_args, fun_kwargs, on_transmitters, point_cls,
                                  request, kwargs)

    def _power_maps(self, X, Y, fun_kwargs, on_transmitters: bool, request: dict, kwargs):
        """The grid accumulators' requests that ``power_map`` expresses:
        one call for ``reduce_all``, else one per fixed point."""
        solver = _SOLVERS[request["path_cls"]]

        def run(single):
            return tracer.power_map(
                single, X, Y, min_order=request["min_order"], max_order=request["max_order"],
                order=request["order"], solver=solver, key=request["key"],
                filter_objects=request["filter_objects"], on_transmitters=on_transmitters,
                grad=request["grad"], value_and_grad=request["value_and_grad"],
                device=self.device, **request["path_cls_kwargs"], **fun_kwargs, **kwargs,
            )

        if request["reduce_all"]:
            return run(self)
        if on_transmitters:
            singles = [(k, self.with_receivers(**{k: v})) for k, v in self.receivers.items()]
        else:
            singles = [(k, self.with_transmitters(**{k: v})) for k, v in self.transmitters.items()]
        return ((name, run(s)) for name, s in singles)

    def _object_maps(self, X, Y, fun, fun_args, fun_kwargs, on_transmitters: bool,
                     point_cls: type, request: dict, kwargs):
        """The grid accumulators' general path: the object API per pixel."""
        candidates = self._np_path_candidates(
            request["min_order"], request["max_order"], order=request["order"],
            filter_objects=request["filter_objects"],
        )
        key = request["key"]
        keys = (list(prng.split(key, len(candidates))) if key is not None
                else [None] * len(candidates))
        objects = self.objects
        interacting = [self.get_interacting_objects(c) for c in candidates]
        path_cls, path_cls_kwargs = request["path_cls"], request["path_cls_kwargs"]

        def facc(fixed: Point, coords: torch.Tensor) -> torch.Tensor:
            acc = torch.zeros((), device=self.device)
            for cand, key_path, objs in zip(candidates, keys, interacting):
                tx_arg, rx_arg = (coords, fixed) if on_transmitters else (fixed, coords)
                path = path_cls.from_tx_objects_rx(tx_arg, objs, rx_arg, key=key_path,
                                                   **path_cls_kwargs)
                valid = path.is_valid(objects, cand, objs, **kwargs)
                pixel = point_cls(xy=coords)
                tx_point, rx_point = (pixel, fixed) if on_transmitters else (fixed, pixel)
                acc = acc + valid * fun(tx_point, rx_point, path, objs, *fun_args, **fun_kwargs)
            return acc

        X = torch.as_tensor(X).to(device=self.device, dtype=torch.float32)
        Y = torch.as_tensor(Y).to(device=self.device, dtype=torch.float32)
        pixels = torch.stack([X.reshape(-1), Y.reshape(-1)], dim=-1)

        def one_map(fixed: Point):
            def f(coords):
                return facc(fixed, coords)

            if request["value_and_grad"]:
                dz, z = torch.func.vmap(torch.func.grad_and_value(f))(pixels)
                return z.reshape(X.shape), dz.reshape(*X.shape, 2)
            if request["grad"]:
                return torch.func.vmap(torch.func.grad(f))(pixels).reshape(*X.shape, 2)
            return torch.func.vmap(f)(pixels).reshape(X.shape)

        fixed = self.receivers if on_transmitters else self.transmitters
        results = ((name, one_map(Point(xy=xy))) for name, xy in fixed.items())
        if not request["reduce_all"]:
            return results
        Z = dZ = torch.zeros((), device=self.device)
        for _, r in results:
            if request["value_and_grad"]:
                Z, dZ = Z + r[0], dZ + r[1]
            else:
                Z = Z + r
        return (Z, dZ) if request["value_and_grad"] else Z


_SOLVERS = {ImagePath: "image", FermatPath: "fermat", MinPath: "mpt"}
_FAST_KWARGS = frozenset({"approx", "alpha", "function", "tol", "patch"})


def _fast_grid(fun, fun_args, fun_kwargs, point_cls, path_cls, path_cls_kwargs, kwargs) -> bool:
    """Whether a grid accumulator's request is a ``power_map`` request, by
    the gates of ``differt2d_tpu.scene.Scene._try_fast_grid``."""
    return (
        fun is received_power and not fun_args and point_cls is Point
        and set(fun_kwargs) <= {"r_coef", "height"} and set(kwargs) <= _FAST_KWARGS
        and path_cls in _SOLVERS and set(path_cls_kwargs) <= {"steps", "many"}
    )


def load_scene_arrays(
    walls,
    kind=None,
    phi=None,
    transmitters: Optional[Mapping] = None,
    receivers: Optional[Mapping] = None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """Scene from another package's scene arrays, given as NumPy.

    ``walls[W, 2, 2]`` (a vertex's location in both ends), ``kind[W]``
    (:data:`KIND_WALL`, ``KIND_RIS`` or ``KIND_VERTEX``; walls by default),
    ``phi[W]`` (the RIS phases; 0 by default) and named points (``xy``
    arrays or ``Point`` objects).  The same arrays build the JAX package's
    scene object by object (``Wall(xys=...)``, ``RIS(xys=..., phi=...)``,
    ``Vertex(xy=walls[i, 0])``, ``Point(xy=...)``); or, from a JAX scene
    ``s``: ``arr = tracer.scene_arrays(s)``, then
    ``load_scene_arrays(np.asarray(arr.walls), np.asarray(arr.kind),
    np.asarray(arr.phi), {k: np.asarray(p.xy) for k, p in
    s.transmitters.items()}, ...)``.  Every array is copied.
    """
    return Scene.from_arrays(
        walls, kind, phi, transmitters, receivers, device=device
    )
