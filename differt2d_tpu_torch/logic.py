"""Smoothed ("soft") boolean logic on tensors.

Counterpart of :mod:`differt2d_tpu.logic`: boolean predicates become floats
in ``[0, 1]`` so that intersection and visibility tests are differentiable.

``approx`` tri-state:

1. ``None`` -- defaults to the module global :data:`ENABLE_APPROX`;
2. ``True`` -- force soft (approximate) logic;
3. ``False`` -- force hard (exact boolean) logic.

Derivatives match JAX's at the kinks: :func:`hard_sigmoid` is
``relu6(z + 3) / 6`` with ``F.relu6``, whose slope is zero where
``z + 3`` is 0 or 6 after float32 rounding, exactly as ``jax.nn.relu6``'s
custom JVP (``F.hardsigmoid`` tests ``-3 < z < 3`` before the addition
and differs where ``z + 3`` rounds to 6); ``torch.minimum`` and
``torch.maximum`` split an exact tie 0.5/0.5 as ``jnp.minimum`` and
``jnp.maximum`` do.  ``torch.clamp`` would give slope 1 at its bounds, so
it is not used on differentiated paths.
"""

from __future__ import annotations

__all__ = (
    "ENABLE_APPROX",
    "activation",
    "disable_approx",
    "enable_approx",
    "false_value",
    "greater",
    "greater_equal",
    "hard_sigmoid",
    "is_false",
    "is_true",
    "less",
    "less_equal",
    "logical_all",
    "logical_and",
    "logical_any",
    "logical_not",
    "logical_or",
    "set_approx",
    "sigmoid",
    "true_value",
)

import os
from contextlib import contextmanager
from threading import RLock
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .defaults import DEFAULT_ALPHA

ENABLE_APPROX: bool = "ENABLE_APPROX" in os.environ
"""Global default for the ``approx`` tri-state."""

_LOCK = RLock()


def set_approx(enable: bool) -> None:
    """Set the global approximation default."""
    global ENABLE_APPROX
    with _LOCK:
        ENABLE_APPROX = enable


@contextmanager
def enable_approx(enable: bool = True):
    """Context manager scoping the global approximation default; the
    previous value is restored on exit."""
    global ENABLE_APPROX
    with _LOCK:
        state = ENABLE_APPROX
        try:
            ENABLE_APPROX = enable
            yield
        finally:
            ENABLE_APPROX = state


@contextmanager
def disable_approx(disable: bool = True):
    """Alias for ``enable_approx(not disable)``."""
    with enable_approx(not disable):
        yield


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def sigmoid(x, alpha) -> torch.Tensor:
    """Slope-``alpha`` sigmoid: ``1 / (1 + exp(-alpha * x))``."""
    return torch.sigmoid(alpha * _t(x))


def hard_sigmoid(x, alpha) -> torch.Tensor:
    """Slope-``alpha`` hard sigmoid: ``relu6(alpha * x + 3) / 6``.

    Saturates exactly at ``|alpha * x| >= 3``, with zero slope there.
    """
    return F.relu6(alpha * _t(x) + 3.0) / 6.0


def activation(
    x,
    alpha=DEFAULT_ALPHA,
    function: Callable[..., torch.Tensor] = hard_sigmoid,
) -> torch.Tensor:
    """Smooth 0-to-1 transition centered at ``x = 0``."""
    return function(x, alpha)


def _resolve(approx: Optional[bool]) -> bool:
    return ENABLE_APPROX if approx is None else approx


def logical_or(x, y, approx: Optional[bool] = None):
    """Soft ``x or y`` = ``maximum``; hard = ``logical_or``."""
    if _resolve(approx):
        return torch.maximum(_t(x), _t(y))
    return torch.logical_or(_t(x), _t(y))


def logical_and(x, y, approx: Optional[bool] = None):
    """Soft ``x and y`` = ``minimum``; hard = ``logical_and``."""
    if _resolve(approx):
        return torch.minimum(_t(x), _t(y))
    return torch.logical_and(_t(x), _t(y))


def logical_not(x, approx: Optional[bool] = None):
    """Soft ``not x`` = ``1 - x``; hard = ``logical_not``."""
    if _resolve(approx):
        return 1.0 - _t(x)
    return torch.logical_not(_t(x))


def greater(x, y, approx: Optional[bool] = None, **kwargs):
    """Soft ``x > y`` = ``activation(x - y)``; hard = ``torch.gt``."""
    if _resolve(approx):
        return activation(_t(x) - y, **kwargs)
    return torch.gt(_t(x), y)


def greater_equal(x, y, approx: Optional[bool] = None, **kwargs):
    """Soft ``x >= y`` = ``activation(x - y)``; hard = ``torch.ge``."""
    if _resolve(approx):
        return activation(_t(x) - y, **kwargs)
    return torch.ge(_t(x), y)


def less(x, y, approx: Optional[bool] = None, **kwargs):
    """Soft ``x < y`` = ``activation(y - x)``; hard = ``torch.lt``."""
    if _resolve(approx):
        return activation(y - _t(x), **kwargs)
    return torch.lt(_t(x), y)


def less_equal(x, y, approx: Optional[bool] = None, **kwargs):
    """Soft ``x <= y`` = ``activation(y - x)``; hard = ``torch.le``."""
    if _resolve(approx):
        return activation(y - _t(x), **kwargs)
    return torch.le(_t(x), y)


def _stack(x) -> torch.Tensor:
    return torch.stack([_t(v) for v in x])


def logical_all(*x, axis=None, approx: Optional[bool] = None):
    """Soft "all true" = ``min``; hard = ``all``, over the stacked inputs."""
    arr = _stack(x)
    if _resolve(approx):
        return torch.amin(arr) if axis is None else torch.amin(arr, dim=axis)
    return torch.all(arr) if axis is None else torch.all(arr, dim=axis)


def logical_any(*x, axis=None, approx: Optional[bool] = None):
    """Soft "any true" = ``max``; hard = ``any``, over the stacked inputs."""
    arr = _stack(x)
    if _resolve(approx):
        return torch.amax(arr) if axis is None else torch.amax(arr, dim=axis)
    return torch.any(arr) if axis is None else torch.any(arr, dim=axis)


def is_true(x, tol: float = 0.5, approx: Optional[bool] = None):
    """Collapse a truthy value to a hard boolean: soft = ``x > 1 - tol``."""
    if _resolve(approx):
        return torch.gt(_t(x), 1.0 - tol)
    return _t(x).to(torch.bool)


def is_false(x, tol: float = 0.5, approx: Optional[bool] = None):
    """Collapse a truthy value to a hard "is false": soft = ``x < tol``."""
    if _resolve(approx):
        return torch.lt(_t(x), tol)
    return torch.logical_not(_t(x))


def true_value(approx: Optional[bool] = None, device=None) -> torch.Tensor:
    """Scalar true: ``1.0`` soft, ``True`` hard (on ``device``, the CPU by
    default)."""
    if _resolve(approx):
        return torch.ones((), device=device)
    return torch.ones((), dtype=torch.bool, device=device)


def false_value(approx: Optional[bool] = None, device=None) -> torch.Tensor:
    """Scalar false: ``0.0`` soft, ``False`` hard (on ``device``, the CPU by
    default)."""
    if _resolve(approx):
        return torch.zeros((), device=device)
    return torch.zeros((), dtype=torch.bool, device=device)
