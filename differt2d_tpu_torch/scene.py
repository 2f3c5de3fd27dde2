"""Scenes as dense tensors (minimal counterpart of :mod:`differt2d_tpu.scene`).

A :class:`Scene` holds every object as a segment ``walls[W, 2, 2]`` with a
per-object ``kind`` (wall, RIS or vertex; a vertex stores its location in
both endpoints) and RIS phase ``phi``, plus named transmitter and receiver
points.  The kinds are also kept on the host as a tuple: they are the
scene's structure (which candidates exist, which kernel serves them) and
reading them never waits for the device.

The object API of the JAX package (``Wall``, ``RIS``, ``Vertex`` and the
scene algebra) is not ported yet; :attr:`Scene.objects` gives light
records for ``filter_objects`` callbacks.

The city scenes read GeoJSON building footprints
(:meth:`Scene.from_geojson`); :meth:`Scene.city_extract_scene` reads the
package's own copy of the JAX package's extract,
``differt2d_tpu_torch/data/city_extract.geojson``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .defaults import (
    DEFAULT_DEVICE,
    KIND_RIS,
    KIND_VERTEX,
    KIND_WALL,
    resolve_device,
)


_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

LOCATIONS = ("N", "E", "S", "W", "C", "NE", "NW", "SE", "SW")
"""Compass anchors of :meth:`Scene.get_location`."""


class SceneObject(NamedTuple):
    """One object of a scene, as handed to ``filter_objects`` callbacks."""

    index: int
    kind: int
    xys: np.ndarray
    phi: float


def _f32(x, device) -> torch.Tensor:
    """Copy ``x`` (array-like or tensor) into a float32 tensor on ``device``.

    NumPy inputs are copied first: ``np.asarray`` of a JAX array is
    read-only, and ``torch.from_numpy`` warns on read-only arrays.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    arr = np.array(x, dtype=np.float32, copy=True)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class Scene:
    """Walls, kinds, RIS phases and named TX/RX points, all on one device.

    Treat a scene as immutable: derive a new one (:meth:`replace`,
    :meth:`update_transmitters`, :meth:`add_ris`, ...) instead of writing
    into its tensors, so that its host-side ``kinds`` stay true.
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
        """Scene from array-likes or tensors (copied to ``device``)."""
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
            transmitters={
                k: _f32(v, dev).reshape(2) for k, v in (transmitters or {}).items()
            },
            receivers={
                k: _f32(v, dev).reshape(2) for k, v in (receivers or {}).items()
            },
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

    def update_transmitters(self, **points) -> "Scene":
        """Add or replace transmitters (``name=xy``)."""
        new = dict(self.transmitters)
        new.update({k: _f32(v, self.device).reshape(2) for k, v in points.items()})
        return self.replace(transmitters=new)

    def _append(self, xys, kind: int, phi: float) -> "Scene":
        row = _f32(xys, self.device).reshape(1, 2, 2)
        return Scene(
            walls=torch.cat([self.walls, row]),
            kind=torch.cat(
                [self.kind, torch.tensor([kind], dtype=torch.int32, device=self.device)]
            ),
            phi=torch.cat([self.phi, _f32([phi], self.device)]),
            transmitters=self.transmitters,
            receivers=self.receivers,
            kinds=(*self.kinds, kind),
        )

    def add_ris(self, xys, phi: float = math.pi / 4) -> "Scene":
        """Append a RIS segment with constant reflection angle ``phi``
        (default pi/4, as the JAX package's ``RIS``)."""
        return self._append(xys, KIND_RIS, phi)

    def add_vertex(self, xy) -> "Scene":
        """Append a diffraction vertex (stored as a zero-length segment)."""
        xy = np.array(xy, dtype=np.float32).reshape(2)
        return self._append(np.stack([xy, xy]), KIND_VERTEX, 0.0)

    def swap_ends(self) -> "Scene":
        """Transmitters become receivers and vice versa (path reversal)."""
        return self.replace(transmitters=self.receivers, receivers=self.transmitters)

    # -- queries ---------------------------------------------------------------

    @property
    def objects(self) -> tuple[SceneObject, ...]:
        """Host-side records of every object (copies the walls to the host)."""
        walls = self.walls.detach().cpu().numpy()
        phi = self.phi.detach().cpu().numpy()
        return tuple(
            SceneObject(i, k, walls[i], float(phi[i]))
            for i, k in enumerate(self.kinds)
        )

    def bounding_box(self) -> torch.Tensor:
        """``[[xmin, ymin], [xmax, ymax]]`` over walls, transmitters and
        receivers."""
        pts = [self.walls.detach().reshape(-1, 2)]
        pts += [v.detach().reshape(1, 2) for v in self.transmitters.values()]
        pts += [v.detach().reshape(1, 2) for v in self.receivers.values()]
        allp = torch.cat(pts)
        return torch.stack([allp.amin(dim=0), allp.amax(dim=0)])

    def get_location(self, location: str) -> torch.Tensor:
        """Compass anchor (one of :data:`LOCATIONS`) of the bounding box, as
        ``differt2d_tpu.abc.Object.get_location`` computes it in float32."""
        if location not in LOCATIONS:
            msg = f"location must be one of {LOCATIONS}, got {location!r}"
            raise ValueError(msg)
        (xmin, ymin), (xmax, ymax) = self.bounding_box()
        xavg = 0.5 * (xmin + xmax)
        yavg = 0.5 * (ymin + ymax)
        x, y = {
            "N": (xavg, ymax), "E": (xmax, yavg), "S": (xavg, ymin),
            "W": (xmin, yavg), "C": (xavg, yavg), "NE": (xmax, ymax),
            "NW": (xmin, ymax), "SE": (xmax, ymin), "SW": (xmin, ymin),
        }[location]
        return torch.stack([x, y])

    def grid(self, m: int = 50, n: Optional[int] = None):
        """Meshgrid ``(X, Y)`` of ``m`` x ``n`` points over the bounding box
        (``X`` and ``Y`` have shape ``[n, m]``)."""
        if n is None:
            n = m
        bb = self.bounding_box().cpu().tolist()
        x = torch.linspace(bb[0][0], bb[1][0], m, device=self.device)
        y = torch.linspace(bb[0][1], bb[1][1], n, device=self.device)
        return torch.meshgrid(x, y, indexing="xy")


def load_scene_arrays(
    walls,
    kind,
    phi,
    transmitters: Mapping,
    receivers: Mapping,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """Scene from another package's scene arrays, given as NumPy.

    For example, from the JAX package:
    ``arr = tracer.scene_arrays(s)``, then
    ``load_scene_arrays(np.asarray(arr.walls), np.asarray(arr.kind),
    np.asarray(arr.phi), {k: np.asarray(p.xy) for k, p in
    s.transmitters.items()}, ...)``.  Every array is copied.
    """
    return Scene.from_arrays(
        walls, kind, phi, transmitters, receivers, device=device
    )
