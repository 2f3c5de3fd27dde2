"""Abstract interfaces of scene objects (counterpart of :mod:`differt2d_tpu.abc`).

:class:`Plottable` gives extents and anchors (bounding box, grid, center,
compass anchors), :class:`Interactable` the parametric interaction protocol
that the path solvers use, and :class:`Object` both.  ``plot`` draws on a
matplotlib axes that the caller passes: the package calls the axes'
methods and never imports matplotlib itself (the GPU machines it runs on
need not have it).
"""

from __future__ import annotations

__all__ = ("LOCATIONS", "Interactable", "Object", "Plottable")

from abc import ABC, abstractmethod
from typing import Any, Optional

import torch

from . import prng
from ._runtime_typing import literal_spec, typecheck
from .defaults import DEFAULT_PATCH

LOCATIONS = ("N", "E", "S", "W", "C", "NE", "NW", "SE", "SW")
"""Compass anchors of :meth:`Plottable.get_location`."""


class Plottable(ABC):
    """Object that can be plotted and has extents
    (``differt2d_tpu.abc.Plottable``)."""

    @abstractmethod
    def plot(self, ax, *args: Any, **kwargs: Any):
        """Plot this object on the matplotlib axes ``ax`` (arguments go to
        the axes' plotting call); returns the artists."""

    @abstractmethod
    def bounding_box(self) -> torch.Tensor:
        """``[[min_x, min_y], [max_x, max_y]]`` extents of this object."""

    def grid(self, m: int = 50, n: Optional[int] = None):
        """Meshgrid ``(X, Y)`` of ``m`` x ``n`` points over the bounding box
        (``X`` and ``Y`` have shape ``[n, m]``), on the box's device."""
        if n is None:
            n = m
        bb = self.bounding_box()
        lo, hi = bb.detach().cpu().tolist()
        x = torch.linspace(lo[0], hi[0], m, device=bb.device)
        y = torch.linspace(lo[1], hi[1], n, device=bb.device)
        return torch.meshgrid(x, y, indexing="xy")

    def center(self) -> torch.Tensor:
        """Center of the bounding box."""
        bb = self.bounding_box()
        return 0.5 * (bb[0, :] + bb[1, :])

    @typecheck(location=literal_spec(*LOCATIONS))
    def get_location(self, location: str) -> torch.Tensor:
        """Compass anchor (one of :data:`LOCATIONS`) of the bounding box,
        computed in float32 as ``differt2d_tpu.abc.Plottable.get_location``
        does; another string raises
        :class:`~differt2d_tpu_torch._runtime_typing.TypeCheckError`."""
        (xmin, ymin), (xmax, ymax) = self.bounding_box()
        xavg = 0.5 * (xmin + xmax)
        yavg = 0.5 * (ymin + ymax)
        x, y = {
            "N": (xavg, ymax), "E": (xmax, yavg), "S": (xavg, ymin),
            "W": (xmin, yavg), "C": (xavg, yavg), "NE": (xmax, ymax),
            "NW": (xmin, ymax), "SE": (xmax, ymin), "SW": (xmin, ymin),
        }[location]
        return torch.stack([x, y])


class Interactable(ABC):
    """Object a ray path can interact with (``differt2d_tpu.abc.Interactable``)."""

    @staticmethod
    @abstractmethod
    def parameters_count() -> int:
        """Number of parametric coordinates of an interaction point."""

    @abstractmethod
    def parametric_to_cartesian(self, param_coords: torch.Tensor) -> torch.Tensor:
        """Map parametric coordinates to cartesian coordinates."""

    @abstractmethod
    def cartesian_to_parametric(self, carte_coords: torch.Tensor) -> torch.Tensor:
        """Map cartesian coordinates to parametric coordinates."""

    @abstractmethod
    def contains_parametric(
        self, param_coords: torch.Tensor, approx: Optional[bool] = None, **kwargs: Any
    ) -> torch.Tensor:
        """Truthy test that the parametric point lies on the object."""

    @abstractmethod
    def intersects_cartesian(
        self,
        ray: torch.Tensor,
        patch: float = DEFAULT_PATCH,
        approx: Optional[bool] = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        """Truthy ray-segment intersection test; ``patch`` grows (``> 0``) or
        shrinks (``< 0``) the object first."""

    @abstractmethod
    def evaluate_cartesian(self, ray_path: torch.Tensor) -> torch.Tensor:
        """Interaction residual of an ``a -> b -> c`` triplet with ``b`` on
        this object: 0 for a physically valid interaction, never negative."""

    def sample(self, key) -> torch.Tensor:
        """Uniform random cartesian point on this object, drawn from the
        :mod:`~differt2d_tpu_torch.prng` key ``key`` as JAX draws it."""
        t = torch.from_numpy(prng.uniform(key, (self.parameters_count(),)))
        return self.parametric_to_cartesian(t.to(self.bounding_box().device))


class Object(Plottable, Interactable):
    """Both :class:`Plottable` and :class:`Interactable`."""
