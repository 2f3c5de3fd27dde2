"""Batched geometric primitives on tensors.

Counterpart of :mod:`differt2d_tpu.ops.geometry_ops`: every function
broadcasts over leading batch axes (pixels x candidates x walls) and keeps
the JAX package's values, guards included.

Every division and square root is guarded twice (a "double where"): the
input is replaced by a safe value where it is degenerate, and the output
is selected afterwards.  Reverse-mode autograd multiplies the zero
cotangent routed around a degenerate branch by that branch's local
derivative; with a single guard that derivative can be infinite
(``sqrt'(0)``, ``x / 0``) and ``0 * inf`` gives NaN.  The JAX tracer takes
its pixel gradients in forward mode and never forms that product; the
port's autograd backward does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..logic import _resolve, activation, logical_and

_EPS32 = float(torch.finfo(torch.float32).eps)


def _safe_norm(vector: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(|v|, |v| == 0)`` over the last axis, with a finite gradient at 0."""
    n2 = torch.sum(vector * vector, dim=-1)
    zero = n2 == 0.0
    length = torch.sqrt(torch.where(zero, torch.ones_like(n2), n2))
    return torch.where(zero, torch.zeros_like(length), length), zero


def segments_intersect(
    p1: torch.Tensor,
    p2: torch.Tensor,
    p3: torch.Tensor,
    p4: torch.Tensor,
    tol: float = 0.005,
    approx: Optional[bool] = None,
    **kwargs: Any,
) -> torch.Tensor:
    r"""Soft/hard test whether segments ``p1-p2`` and ``p3-p4`` intersect.

    Graphics-Gems parametric test: both line parameters must lie in
    ``[-tol, 1 + tol]``; a zero denominator (parallel or colinear) maps the
    parameter to ``+inf``, so the test is false.

    In soft mode the activations at ``t = +inf`` are taken as constants
    (their saturated values, with zero derivative), so no ``inf * 0``
    enters the backward pass, not even for a differentiated ``alpha``.

    :return: Truthy tensor of the broadcast batch shape (float in soft
        mode, bool in hard mode).
    """
    a_vec = p2 - p1
    b_vec = p3 - p4
    c_vec = p1 - p3
    num_alpha = b_vec[..., 1] * c_vec[..., 0] - b_vec[..., 0] * c_vec[..., 1]
    num_beta = a_vec[..., 0] * c_vec[..., 1] - a_vec[..., 1] * c_vec[..., 0]
    den = a_vec[..., 1] * b_vec[..., 0] - a_vec[..., 0] * b_vec[..., 1]

    den_is_zero = den == 0.0
    safe_den = torch.where(den_is_zero, torch.ones_like(den), den)
    approx = _resolve(approx)
    upper = 1.0 + torch.as_tensor(tol, dtype=den.dtype)
    lower = -torch.as_tensor(tol, dtype=den.dtype)

    def in_unit_range(num: torch.Tensor) -> torch.Tensor:
        if not approx:
            t = torch.where(den_is_zero, torch.inf, num / safe_den)
            return (t >= lower) & (t <= upper)
        t = torch.where(den_is_zero, torch.zeros_like(num), num / safe_den)
        inf = torch.full((), torch.inf, dtype=den.dtype, device=den.device)
        # Saturated values at t = +inf: activation(+inf) and activation(-inf).
        ge_inf = activation(inf, **kwargs).detach()
        le_inf = activation(-inf, **kwargs).detach()
        ge = torch.where(den_is_zero, ge_inf, activation(t - lower, **kwargs))
        le = torch.where(den_is_zero, le_inf, activation(upper - t, **kwargs))
        return logical_and(ge, le, approx=True)

    return logical_and(
        in_unit_range(num_alpha), in_unit_range(num_beta), approx=approx
    )


def path_length(points: torch.Tensor) -> torch.Tensor:
    """Total polyline length over the ``[..., N, 2]`` point axis.

    Adds machine epsilon to each segment vector so the gradient of the norm
    is finite at zero-length segments.
    """
    vectors = torch.diff(points, dim=-2) + _EPS32
    lengths, _ = _safe_norm(vectors)
    return torch.sum(lengths, dim=-1)


def normalize(vector: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize ``[..., 2]`` vectors, returning (unit vector, length).

    Zero vectors map to (zero vector, length 1).
    """
    length, zero = _safe_norm(vector)
    safe = torch.where(zero, torch.ones_like(length), length)
    return vector / safe[..., None], safe


def wall_normal(walls: torch.Tensor) -> torch.Tensor:
    """Unit normal of ``[..., 2, 2]`` walls: the direction rotated by -90
    degrees (``n = [t_y, -t_x]``), then normalized."""
    t = walls[..., 1, :] - walls[..., 0, :]
    n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    n, _ = normalize(n)
    return n


def mirror_point(point: torch.Tensor, walls: torch.Tensor) -> torch.Tensor:
    """Mirror image of ``[..., 2]`` points across ``[..., 2, 2]`` walls."""
    n = wall_normal(walls)
    incident = point - walls[..., 0, :]
    return point - 2.0 * torch.sum(incident * n, dim=-1, keepdim=True) * n


def parametric_to_cartesian(walls: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Point on ``[..., 2, 2]`` walls at parameter ``t``."""
    origin = walls[..., 0, :]
    direction = walls[..., 1, :] - walls[..., 0, :]
    return origin + t[..., None] * direction


def cartesian_to_parametric(walls: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Parameter of the projection of ``point`` onto ``[..., 2, 2]`` walls.

    Zero-length walls are guarded to squared length 1.
    """
    direction = walls[..., 1, :] - walls[..., 0, :]
    other = point - walls[..., 0, :]
    sq_len = torch.sum(direction * direction, dim=-1)
    sq_len = torch.where(sq_len == 0.0, torch.ones_like(sq_len), sq_len)
    return torch.sum(direction * other, dim=-1) / sq_len


def specular_residual(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, walls: torch.Tensor
) -> torch.Tensor:
    """Squared deviation of ``a -> b -> c`` from specular reflection on walls:
    ``|r_hat - reflect(i_hat, n)|^2``."""
    n = wall_normal(walls)
    i, _ = normalize(b - a)
    r, _ = normalize(c - b)
    reflected = i - 2.0 * torch.sum(i * n, dim=-1, keepdim=True) * n
    e = r - reflected
    return torch.sum(e * e, dim=-1)


def ris_residual(
    b: torch.Tensor, c: torch.Tensor, walls: torch.Tensor, phi: torch.Tensor
) -> torch.Tensor:
    """Residual forcing a constant reflection angle ``phi`` off a RIS:
    ``(sin a - sin phi)^2 + (cos a - cos phi)^2`` with ``a`` the angle of
    the outgoing ray w.r.t. the surface normal."""
    n = wall_normal(walls)
    r, _ = normalize(c - b)
    sin_a = (-r[..., 0]) * n[..., 1] - (-r[..., 1]) * n[..., 0]
    cos_a = torch.sum((-r) * n, dim=-1)
    return (sin_a - torch.sin(phi)) ** 2 + (cos_a - torch.cos(phi)) ** 2
