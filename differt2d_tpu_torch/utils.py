"""Comparison helpers (counterpart of ``differt2d_tpu/utils.py``)."""

from __future__ import annotations

import numpy as np


def kink_excess(
    actual,
    desired,
    rtol: float = 1e-4,
    atol: float = 1e-5,
    frac: float = 0.005,
) -> tuple[int, float]:
    """Count gradient-map pixels beyond tolerance vs the kink allowance.

    Analytic in-kernel gradients agree with automatic differentiation
    everywhere except KINK pixels -- pixels within one f32 ulp of a
    soft-min/max crossover, where the two computations pick different
    (equally valid) subgradients.  Returns ``(n_bad, allowed)``: the
    comparison satisfies the contract iff ``n_bad <= allowed``.  The
    allowance is ``max(4, frac * size)`` -- kinks live on
    validity-transition *curves*, so small grids get an absolute floor
    rather than a share of the area.
    """
    a = _to_numpy(actual)
    d = _to_numpy(desired)
    bad = np.abs(a - d) > (atol + rtol * np.abs(d))
    return int(bad.sum()), max(4.0, frac * bad.size)


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
