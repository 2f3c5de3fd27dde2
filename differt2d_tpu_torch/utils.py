"""Physics and comparison helpers (counterpart of ``differt2d_tpu/utils.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .defaults import DEFAULT_HEIGHT, DEFAULT_R_COEF

P0: float = 100.0
"""Received power at zero distance with the default parameters."""


def received_power(transmitter, receiver, path, interacting_objects: Sequence,
                   r_coef=DEFAULT_R_COEF, height=DEFAULT_HEIGHT):
    """Received power along a path: ``r_coef**n / (height**2 + r**2)``, with
    ``n`` the path's interactions and ``r`` its length; ``height`` keeps it
    finite where the transmitter is the receiver.  The transmitter, the
    receiver and the objects are taken (and ignored) for the accumulators'
    path-function protocol."""
    r = path.length()
    n = path.xys.shape[0] - 2
    return (r_coef**n) / (height * height + r * r)


received_power.vectorized = True  # type: ignore[attr-defined]
"""Marker: safe to vectorize over batched paths (the JAX package's fast grid
path reads it)."""


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
