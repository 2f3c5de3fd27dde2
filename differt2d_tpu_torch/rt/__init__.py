"""Path-candidate enumeration (counterpart of :mod:`differt2d_tpu.rt`)."""

from .graph import candidates_for_order, path_candidate_matrices

__all__ = ("candidates_for_order", "path_candidate_matrices")
