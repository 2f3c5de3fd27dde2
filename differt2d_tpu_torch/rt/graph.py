"""Combinatorial path-candidate enumeration (NumPy).

Counterpart of :mod:`differt2d_tpu.rt.graph`:

* objects are graph nodes ``0 .. n-1``;
* a path candidate of ``order`` interactions is a sequence of ``order``
  node indices with **no two consecutive repeats**, giving
  ``m * (m - 1)**(order - 1)`` candidates over ``m`` allowed nodes;
* ``filter_nodes`` removes nodes entirely;
* rows come out in lexicographic order of node index;
* :class:`CompleteGraph` and :class:`DiGraph` are the JAX package's stand-ins
  for ``differt_core.rt``'s graphs: the virtual from/to nodes are
  ``num_nodes`` and ``num_nodes + 1``, and a path's ``depth`` counts them.

Sets of :data:`~._native.NATIVE_THRESHOLD` (1,024) rows or more, such as
the city extract's 18,360 order-2 candidates, come from the native C++
enumerator (:mod:`._native`), smaller ones from a vectorized NumPy
mixed-radix decoder; both give the same arrays.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .._runtime_typing import SCALAR_INT_STRICT, typecheck, unchecked
from . import _native


def _decode_candidates(allowed: np.ndarray, order: int) -> np.ndarray:
    """Enumerate all no-consecutive-repeat sequences over ``allowed``: the
    native enumerator from :data:`~._native.NATIVE_THRESHOLD` rows,
    :func:`_numpy_decode` below.

    :param allowed: Sorted unique node indices, shape ``[m]``.
    :param order: Number of interactions (sequence length), ``>= 1``.
    :return: ``int32[m * (m - 1)**(order - 1), order]``.
    """
    m = int(allowed.shape[0])
    if m == 0 or (order >= 2 and m == 1):
        return np.empty((0, order), dtype=np.int32)
    if m * (m - 1) ** (order - 1) >= _native.NATIVE_THRESHOLD:
        return _native.enumerate_paths(allowed, order)
    return _numpy_decode(allowed, order)


def _numpy_decode(allowed: np.ndarray, order: int) -> np.ndarray:
    """Mixed-radix decode: the first digit has ``m`` choices, each later
    digit ``m - 1`` choices (all allowed nodes except the previous one, in
    increasing order).  Digit significance decreases left to right, so the
    rows come out in lexicographic order.  ``allowed`` has ``m >= 1`` nodes
    (``m >= 2`` from order 2)."""
    m = int(allowed.shape[0])
    total = m * (m - 1) ** (order - 1)
    idx = np.arange(total, dtype=np.int64)
    # Positions into `allowed`, not node values, until the final gather.
    positions = np.empty((total, order), dtype=np.int64)
    for j in range(order - 1, 0, -1):
        idx, digit = np.divmod(idx, m - 1)
        positions[:, j] = digit
    positions[:, 0] = idx
    # Skip-the-previous map: digit d at position j refers to the d-th
    # allowed node once the previous node is removed from the ordering.
    for j in range(1, order):
        prev = positions[:, j - 1]
        d = positions[:, j]
        positions[:, j] = d + (d >= prev)
    return allowed[positions].astype(np.int32)


@lru_cache(maxsize=256)
def candidates_for_order(
    num_nodes: int,
    order: int,
    filter_nodes: Optional[tuple[int, ...]] = None,
) -> np.ndarray:
    """All candidates of exactly ``order`` interactions, as one matrix.

    :return: ``int32[num_candidates, order]`` (cached and read-only).
    """
    if order == 0:
        out = np.empty((1, 0), dtype=np.int32)
    else:
        allowed = np.arange(num_nodes, dtype=np.int64)
        if filter_nodes:
            allowed = np.setdiff1d(
                allowed, np.asarray(filter_nodes, dtype=np.int64)
            )
        out = _decode_candidates(allowed, order)
    out.flags.writeable = False
    return out


@typecheck(
    num_nodes=SCALAR_INT_STRICT,
    min_order=SCALAR_INT_STRICT,
    max_order=SCALAR_INT_STRICT,
)
def path_candidate_matrices(
    num_nodes: int,
    min_order: int = 0,
    max_order: int = 1,
    *,
    order: Optional[int] = None,
    filter_nodes: Optional[Sequence[int]] = None,
) -> dict[int, np.ndarray]:
    """Candidates grouped per order: ``{order: int32[C_o, order]}``."""
    if order is not None:
        min_order = max_order = order
    key = tuple(sorted(int(i) for i in filter_nodes)) if filter_nodes is not None else None
    return {
        o: candidates_for_order(int(num_nodes), o, key)
        for o in range(int(min_order), int(max_order) + 1)
    }


@typecheck(
    num_nodes=SCALAR_INT_STRICT,
    min_order=SCALAR_INT_STRICT,
    max_order=SCALAR_INT_STRICT,
)
def all_path_candidates(
    num_nodes: int,
    min_order: int = 0,
    max_order: int = 1,
    *,
    order: Optional[int] = None,
    filter_nodes: Optional[Sequence[int]] = None,
) -> list[torch.Tensor]:
    """Every candidate as its own ``int32[order]`` tensor on the CPU,
    order-major, then lexicographic (``differt2d_tpu.rt.all_path_candidates``).

    >>> [c.tolist() for c in all_path_candidates(3, max_order=1)]
    [[], [0], [1], [2]]
    """
    groups = unchecked(path_candidate_matrices)(
        num_nodes, min_order=min_order, max_order=max_order, order=order,
        filter_nodes=filter_nodes,
    )
    return [row for o in sorted(groups) for row in torch.from_numpy(groups[o].copy()).unbind(0)]


def _paths(num_nodes: int, from_: int, to: int, depth: int, include_from_and_to: bool,
           filter_nodes: Optional[tuple[int, ...]] = None) -> Iterator[np.ndarray]:
    """The rows of :func:`candidates_for_order` at order ``depth - 2``, each
    between ``from_`` and ``to`` when ``include_from_and_to``."""
    for row in candidates_for_order(num_nodes, depth - 2, filter_nodes):
        if include_from_and_to:
            yield np.concatenate(([from_], row, [to])).astype(np.int32)
        else:
            yield row


class CompleteGraph:
    """Complete graph over ``num_nodes`` object nodes
    (``differt2d_tpu.rt.CompleteGraph``, the stand-in for
    ``differt_core.rt.CompleteGraph``): the virtual from/to nodes are
    ``num_nodes`` and ``num_nodes + 1``."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes

    def all_paths(self, from_: int, to: int, depth: int,
                  include_from_and_to: bool = False) -> Iterator[np.ndarray]:
        """The paths of ``depth`` nodes from ``from_`` to ``to``: ``depth``
        counts the two ends, so each has ``depth - 2`` interactions
        (``int32`` rows, read-only without the ends)."""
        return _paths(self.num_nodes, from_, to, depth, include_from_and_to)


class DiGraph:
    """Directed graph with disconnected nodes (``differt2d_tpu.rt.DiGraph``,
    the stand-in for ``differt_core.rt.DiGraph``)."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self._disconnected: set[int] = set()

    @classmethod
    def from_complete_graph(cls, graph: CompleteGraph) -> "DiGraph":
        return cls(graph.num_nodes)

    def insert_from_and_to_nodes(self) -> tuple[int, int]:
        """The virtual from/to nodes: ``(num_nodes, num_nodes + 1)``."""
        return self.num_nodes, self.num_nodes + 1

    def disconnect_nodes(self, *nodes: int) -> None:
        """Remove ``nodes`` from every later path."""
        self._disconnected.update(int(n) for n in nodes)

    def all_paths(self, from_: int, to: int, depth: int,
                  include_from_and_to: bool = False) -> Iterator[np.ndarray]:
        """:meth:`CompleteGraph.all_paths` over the connected nodes."""
        return _paths(self.num_nodes, from_, to, depth, include_from_and_to,
                      tuple(sorted(self._disconnected)))
