"""Path-candidate enumeration (counterpart of :mod:`differt2d_tpu.rt`):
candidate matrices per order, the flat list form and the graph stand-ins of
``differt_core.rt``; :func:`available` says whether the native enumerator
loads."""

from ._native import available
from .graph import (
    CompleteGraph,
    DiGraph,
    all_path_candidates,
    candidates_for_order,
    path_candidate_matrices,
)

__all__ = (
    "CompleteGraph",
    "DiGraph",
    "all_path_candidates",
    "available",
    "candidates_for_order",
    "path_candidate_matrices",
)
