"""Combinatorial path-candidate enumeration (NumPy).

Counterpart of :mod:`differt2d_tpu.rt.graph`:

* objects are graph nodes ``0 .. n-1``;
* a path candidate of ``order`` interactions is a sequence of ``order``
  node indices with **no two consecutive repeats**, giving
  ``m * (m - 1)**(order - 1)`` candidates over ``m`` allowed nodes;
* ``filter_nodes`` removes nodes entirely;
* rows come out in lexicographic order of node index.

Only the vectorized mixed-radix decoder is carried over: the native
enumerator of the JAX package serves sets of 4096 rows and more, which no
path of this package reaches yet.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np


def _decode_candidates(allowed: np.ndarray, order: int) -> np.ndarray:
    """Enumerate all no-consecutive-repeat sequences over ``allowed``.

    Mixed-radix decode: the first digit has ``m`` choices, each later digit
    ``m - 1`` choices (all allowed nodes except the previous one, in
    increasing order).  Digit significance decreases left to right, so the
    rows come out in lexicographic order.

    :param allowed: Sorted unique node indices, shape ``[m]``.
    :param order: Number of interactions (sequence length), ``>= 1``.
    :return: ``int32[m * (m - 1)**(order - 1), order]``.
    """
    m = int(allowed.shape[0])
    if m == 0 or (order >= 2 and m == 1):
        return np.empty((0, order), dtype=np.int32)

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


def path_candidate_matrices(
    num_nodes: int,
    min_order: int = 0,
    max_order: int = 1,
    *,
    order: Optional[int] = None,
    filter_nodes: Optional[Sequence[int]] = None,
) -> dict[int, np.ndarray]:
    """Candidates grouped per order: ``{order: int32[C_o, order]}``."""
    for name, value in (
        ("num_nodes", num_nodes),
        ("min_order", min_order),
        ("max_order", max_order),
    ):
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            msg = f"{name} must be an int, got {type(value).__name__}"
            raise TypeError(msg)
    if order is not None:
        min_order = max_order = order
    key = tuple(sorted(int(i) for i in filter_nodes)) if filter_nodes is not None else None
    return {
        o: candidates_for_order(int(num_nodes), o, key)
        for o in range(int(min_order), int(max_order) + 1)
    }
