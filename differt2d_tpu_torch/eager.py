"""Batched grid tracer in eager PyTorch: the plain version of the kernels.

Counterpart of the batched part of :mod:`differt2d_tpu.tracer` (the image,
Fermat and MPT solvers, the validity tests and the power model,
``tracer.py:140-508``).
The JAX package vmaps a per-pixel function over the pixel axis; here the
pixel axis is written out, and every step is tensor code over
``[pixels, candidates, segments, walls]``:

* a scene is ``walls[W, 2, 2]`` plus per-object ``kind``/``phi``;
* candidates are ``int32[C, order]`` matrices grouped per order;
* the map is chunked over pixels so memory stays bounded.

:func:`eager_value`, :func:`eager_value_and_grad` and :func:`eager_vjp` are
the plain PyTorch versions of the CUDA kernels
(:mod:`differt2d_tpu_torch.ops.power_map_kernel`,
:mod:`~differt2d_tpu_torch.ops.opt_solver_kernel`) and the eager route of
:func:`differt2d_tpu_torch.tracer.power_map`.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from . import optimize, prng
from ._runtime_typing import unchecked
from .defaults import KIND_RIS, KIND_VERTEX
from .ops import geometry_ops as _ops

# Elements of the largest [pixels, candidates, segments, walls] tensor in
# one chunk of the eager tracer (2**22 floats = 16 MiB per temporary).
_CHUNK_ELEMENTS = 1 << 22


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Dense tensors of a scene's objects: ``walls[W, 2, 2]``, ``kind[W]``
    (int), ``phi[W]``."""

    walls: torch.Tensor
    kind: torch.Tensor
    phi: torch.Tensor

    @property
    def num_objects(self) -> int:
        return self.walls.shape[0]


# -- batched solver / validity ----------------------------------------------
# ``cw[C, o, 2, 2]``, ``ckind[C, o]``, ``cphi[C, o]`` are the candidate-
# gathered objects; points carry leading ``[P, C]`` axes.


def _bounce_residuals(pts_full, cw, ckind, cphi) -> torch.Tensor:
    """Sum of interaction residuals along each candidate path, ``[P, C]``.

    Per bounce, by kind: wall -> specular, RIS -> constant angle,
    vertex -> 0.
    """
    if cw.shape[1] == 0:
        return torch.zeros(pts_full.shape[:2], device=pts_full.device)
    a = pts_full[..., :-2, :]
    b = pts_full[..., 1:-1, :]
    c = pts_full[..., 2:, :]
    spec = _ops.specular_residual(a, b, c, cw)
    ris = _ops.ris_residual(b, c, cw, cphi)
    res = torch.where(ckind == KIND_RIS, ris, spec)
    res = torch.where(ckind == KIND_VERTEX, torch.zeros_like(res), res)
    return torch.sum(res, dim=-1)


def _solve_image(tx, rx, cw, ckind) -> torch.Tensor:
    """Image-method bounce points for every candidate, ``[P, C, o, 2]``.

    ``tx``/``rx`` are ``[P or 1, 1, 2]``.  Forward mirror sweep, then
    backward line-wall intersection with the ``un == 0`` guard; vertex
    bounces are pinned to the vertex location.
    """
    C, o = cw.shape[0], cw.shape[1]
    image = tx.expand(tx.shape[0], C, 2)
    images = []
    for i in range(o):
        image = _ops.mirror_point(image, cw[:, i])
        images.append(image)

    point = rx.expand(rx.shape[0], C, 2)
    points: list = [None] * o
    for i in range(o - 1, -1, -1):
        wall_i = cw[:, i]
        normal = _ops.wall_normal(wall_i)
        u = point - images[i]
        v = wall_i[:, 0, :] - point
        un = torch.sum(u * normal, dim=-1)
        vn = torch.sum(v * normal, dim=-1)
        un_zero = un == 0.0
        safe_un = torch.where(un_zero, torch.ones_like(un), un)
        inc = torch.where(
            un_zero[..., None], torch.zeros_like(u), (vn / safe_un)[..., None] * u
        )
        point = point + inc
        point = torch.where(
            (ckind[:, i] == KIND_VERTEX)[:, None], wall_i[:, 0, :], point
        )
        points[i] = point
    return torch.stack(points, dim=-2)


def _theta_to_points(theta, cw, ckind) -> torch.Tensor:
    """Bounce points ``[..., C, o, 2]`` of per-bounce parameters
    ``theta[..., C, o]``: the point at parameter t on a wall or RIS, the
    location of a vertex (whose parameter is inert)."""
    on_wall = _ops.parametric_to_cartesian(cw, theta)
    return torch.where((ckind == KIND_VERTEX)[..., None], cw[..., 0, :], on_wall)


def _solve_opt(tx, rx, cw, ckind, cphi, x0, objective: str, steps: int,
               implicit: bool = False):
    """Fermat (``"fermat"``) or MPT (``"mpt"``) solve of every candidate.

    ``tx``/``rx`` are ``[P or 1, 1, 2]``; ``x0[C, M, o]`` holds each
    candidate's ``M`` initial parameter vectors.  Each start runs
    :func:`optimize.minimize` on the path length (Fermat) or the summed
    interaction residual (MPT); with ``M > 1`` the start of least final
    loss wins (first on ties).  The loss follows the JAX package: the
    residual at the solution for Fermat, the solve's last loss for MPT.
    ``implicit`` differentiates each solve by the implicit-function theorem
    (``optimize.minimize(implicit=True)``; one ``o x o`` Hessian block per
    pixel and start) instead of through its unrolled steps.

    :return: ``(points[P, C, o, 2], loss[P, C])``.
    """
    C, M, o = x0.shape
    P = max(tx.shape[0], rx.shape[0])
    CM = C * M
    cwm = cw.repeat_interleave(M, dim=0)
    ckm = ckind.repeat_interleave(M, dim=0)
    cpm = cphi.repeat_interleave(M, dim=0)
    txe = tx.expand(P, CM, 2)[:, :, None, :]
    rxe = rx.expand(P, CM, 2)[:, :, None, :]

    def fun(theta, txe, rxe, cwm, cpm):
        full = torch.cat([txe, _theta_to_points(theta, cwm, ckm), rxe], dim=2)
        if objective == "fermat":
            return _ops.path_length(full)
        return _bounce_residuals(full, cwm, ckm, cpm)

    theta0 = x0.reshape(1, CM, o).expand(P, CM, o)
    theta, last = unchecked(optimize.minimize)(fun, theta0, args=(txe, rxe, cwm, cpm),
                                               steps=steps, implicit=implicit)
    theta, last = theta.reshape(P, C, M, o), last.reshape(P, C, M)
    if M > 1:
        best = torch.argmin(last, dim=-1, keepdim=True)  # [P, C, 1]
        theta = torch.take_along_dim(theta, best[..., None], dim=2)
        last = torch.take_along_dim(last, best, dim=2)
    theta, last = theta[:, :, 0], last[:, :, 0]
    pts = _theta_to_points(theta, cw, ckind)
    if objective == "mpt":
        return pts, last
    full = torch.cat([tx.expand(P, C, 2)[:, :, None], pts, rx.expand(P, C, 2)[:, :, None]], dim=2)
    return pts, _bounce_residuals(full, cw, ckind, cphi)


def _on_objects(pts, cw, ckind, approx: bool, alpha, function) -> torch.Tensor:
    """Soft/hard AND over "bounce i lies on object i", ``[P, C]``."""
    P, C, o = pts.shape[0], pts.shape[1], pts.shape[2]
    if o == 0:
        if approx:
            return torch.ones(P, C, device=pts.device)
        return torch.ones(P, C, dtype=torch.bool, device=pts.device)
    t = _ops.cartesian_to_parametric(cw, pts)
    is_vertex = ckind == KIND_VERTEX
    if approx:
        ge = function(t - 0.0, alpha)
        le = function(1.0 - t, alpha)
        contains = torch.minimum(ge, le)
        contains = torch.where(is_vertex, torch.ones_like(contains), contains)
        return torch.amin(contains, dim=-1)
    contains = (t >= 0.0) & (t <= 1.0)
    contains = contains | is_vertex
    return torch.all(contains, dim=-1)


def _blocked(
    pts_full, cand, arrays: SceneArrays, patch, approx: bool, alpha, function,
    tol_intersect: float = 0.005, listed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Soft/hard OR over "segment s is blocked by non-adjacent object w".

    Every path segment is tested against every wall, with the two objects
    adjacent to the segment masked out and vertices never blocking.
    ``listed`` (bool, broadcastable to ``[P, C, S, W]``) masks out the walls
    off a segment's occluder list as well (the looped kernels' plain
    version).
    """
    P, C = pts_full.shape[0], pts_full.shape[1]
    W = arrays.num_objects
    if W == 0:
        if approx:
            return torch.zeros(P, C, device=pts_full.device)
        return torch.zeros(P, C, dtype=torch.bool, device=pts_full.device)

    seg_a = pts_full[..., :-1, :][..., None, :]  # [P, C, S, 1, 2]
    seg_b = pts_full[..., 1:, :][..., None, :]

    walls = arrays.walls
    direction = walls[:, 1, :] - walls[:, 0, :]
    w_a = walls[:, 0, :] - patch * direction
    w_b = walls[:, 1, :] + patch * direction

    hit = _ops.segments_intersect(
        w_a, w_b, seg_a, seg_b, tol=tol_intersect, approx=approx,
        alpha=alpha, function=function,
    )  # [P, C, S, W]

    # Interacting indices are [-1, cand..., -1]; segment s connects node s
    # to node s + 1.
    minus = torch.full((C, 1), -1, dtype=cand.dtype, device=cand.device)
    idx = torch.cat([minus, cand, minus], dim=1)  # [C, S + 1]
    wall_ids = torch.arange(W, device=cand.device)[None, None, :]
    ignore = (wall_ids == idx[:, :-1, None]) | (wall_ids == idx[:, 1:, None])
    ignore = ignore | (arrays.kind == KIND_VERTEX)[None, None, :]
    if listed is not None:
        ignore = ignore | ~listed

    if approx:
        hit = torch.where(ignore, torch.zeros_like(hit), hit)
        return torch.amax(hit.reshape(P, C, -1), dim=-1)
    hit = hit & ~ignore
    return torch.any(hit.reshape(P, C, -1), dim=-1)


def _received_power_batched(pts_full, order: int, r_coef, height) -> torch.Tensor:
    """Power model ``r_coef**order / (h^2 + r^2)`` per candidate path."""
    r = _ops.path_length(pts_full)
    return (r_coef**order) / (height * height + r * r)


def _trace_group(
    tx, rx, arrays: SceneArrays, order: int, cand: torch.Tensor, *,
    approx: bool, alpha, function, tol, patch, listed=None, solve=None,
):
    """Solve and validate one order group of candidates.

    ``tx``/``rx`` are ``[P or 1, 1, 2]``; ``cand`` is ``long[C, order]``;
    ``listed`` restricts the blocked test (see :func:`_blocked`).
    ``solve`` picks the solver: None for the image method,
    :data:`PINNED` for Fermat/MPT candidates of vertices only (every bounce
    is pinned to its vertex and its residual is 0, so the solve is skipped,
    as the JAX package skips it), or ``(objective, steps, x0, implicit)``
    for :func:`_solve_opt`.

    :return: ``(pts_full[P, C, order+2, 2], loss[P, C], valid[P, C])``.
    """
    C = cand.shape[0]
    P = max(tx.shape[0], rx.shape[0])
    cw = arrays.walls[cand]  # [C, o, 2, 2]
    ckind = arrays.kind[cand]
    cphi = arrays.phi[cand]
    ends = (tx.expand(P, C, 2)[:, :, None, :], rx.expand(P, C, 2)[:, :, None, :])

    if order == 0:
        pts = torch.zeros(P, C, 0, 2, device=tx.device)
        loss = torch.zeros(P, C, device=tx.device)
    elif solve is None:
        pts = _solve_image(tx, rx, cw, ckind)
        loss = _bounce_residuals(torch.cat([ends[0], pts, ends[1]], dim=2), cw, ckind, cphi)
    elif solve is PINNED:
        pts = cw[:, :, 0, :].expand(P, C, order, 2)
        loss = torch.zeros(P, C, device=tx.device)
    else:
        objective, steps, x0, implicit = solve
        pts, loss = _solve_opt(tx, rx, cw, ckind, cphi, x0, objective, steps, implicit)
    pts_full = torch.cat([ends[0], pts, ends[1]], dim=2)

    on = _on_objects(pts, cw, ckind, approx, alpha, function)
    blk = _blocked(pts_full, cand, arrays, patch, approx, alpha, function, listed=listed)
    if approx:
        loss_ok = function(tol - loss, alpha)
        valid = torch.minimum(torch.minimum(on, 1.0 - blk), loss_ok)
        valid = torch.nan_to_num(valid)
    else:
        valid = on & ~blk & (loss < tol)
    return pts_full, loss, valid


def _accumulate_pixel(
    tx, rx, arrays: SceneArrays, groups, *, approx: bool, alpha, function,
    tol, patch, power_fun, solves=None,
) -> torch.Tensor:
    """Sum over orders and candidates of ``valid * power``, per pixel.

    ``tx``/``rx`` are ``[P, 2]`` or ``[2]``; ``groups`` is a list of
    ``(order, long[C, order])``; ``solves`` gives each group's ``solve``
    (see :func:`_trace_group`; None for all: the image method).
    """
    tx3 = tx.reshape(-1, 1, 2)
    rx3 = rx.reshape(-1, 1, 2)
    P = max(tx3.shape[0], rx3.shape[0])
    acc = torch.zeros(P, device=tx3.device)
    for k, (order, cand) in enumerate(groups):
        if cand.shape[0] == 0:
            continue
        pts_full, _, valid = _trace_group(
            tx3, rx3, arrays, order, cand, approx=approx, alpha=alpha,
            function=function, tol=tol, patch=patch,
            solve=None if solves is None else solves[k],
        )
        power = power_fun(pts_full, order)
        acc = acc + torch.sum(valid * power, dim=-1)
    return acc


# -- chunked eager maps ---------------------------------------------------------


PINNED = "pinned"
"""``solve`` of a Fermat/MPT group whose candidates are vertices only."""


@dataclasses.dataclass(frozen=True)
class EagerSpec:
    """Everything of an eager map but its differentiable tensors.

    ``solver`` is ``"image"``, ``"fermat"`` or ``"mpt"``; the last two take
    ``steps`` adam steps from ``many`` starts per candidate, drawn from
    ``keys`` (per group, the ``uint32[C, 2]`` keys of its candidates, see
    :func:`group_keys`; None without a key), and need the scene's host
    ``kinds`` to find the groups of vertices only; ``implicit`` picks the
    solves' implicit-function derivatives (``solver_grad="implicit"``).
    """

    groups: tuple  # ((order, long[C, order] tensor), ...)
    approx: bool
    function: Callable
    on_transmitters: bool = False
    power_fun: Optional[Callable] = None
    solver: str = "image"
    steps: int = 100
    many: int = 1
    keys: Optional[tuple] = None
    kinds: Optional[tuple] = None
    implicit: bool = False

    @functools.cached_property
    def solves(self) -> Optional[tuple]:
        """Per group, its ``solve`` argument of :func:`_trace_group` (None
        for the image method); raises for a group that needs a key and has
        none, as the JAX tracer does."""
        if self.solver == "image":
            return None
        out = []
        for k, (order, cand) in enumerate(self.groups):
            rows = np.asarray(optimize.constants(cand.cpu()).tolist(), dtype=np.int64)
            if order == 0 or cand.shape[0] == 0:
                out.append(None)
            elif np.all(np.asarray(self.kinds)[rows] == KIND_VERTEX):
                out.append(PINNED)
            elif self.keys is None or self.keys[k] is None:
                msg = f"solver {self.solver!r} requires a PRNG key"
                raise ValueError(msg)
            else:
                x0 = solver_inits(self.keys[k], order, self.many)
                out.append((self.solver, int(self.steps),
                            optimize.constants(torch.from_numpy(x0).to(cand.device)),
                            self.implicit))
        return tuple(out)

    def chunk(self, num_walls: int, track: bool = False) -> int:
        """Pixels per chunk, so the largest temporary stays bounded.  A
        recorded (``track``) solve keeps every step's temporaries."""
        per_pixel = 0
        for o, c in self.groups:
            n = int(c.shape[0]) * (o + 1) * max(num_walls, 1)
            if self.solver != "image" and o > 0:
                n *= self.many * (max(1, self.steps // 16) if track else 1)
            per_pixel += n
        return max(1, _CHUNK_ELEMENTS // max(per_pixel, 1))


def group_keys(groups: dict, key) -> tuple:
    """Per group of ``groups`` (``{order: int32[C, order]}``, in order),
    the keys of its candidates: one key per candidate from ``split(key,
    total)`` in the global order-major enumeration, so order-0 candidates
    use up keys before order 1 (``tracer.py:571-581``)."""
    keys = prng.split(key, sum(int(g.shape[0]) for g in groups.values()))
    out, start = [], 0
    for _, g in sorted(groups.items()):
        out.append(keys[start : start + g.shape[0]])
        start += g.shape[0]
    return tuple(out)


def solver_inits(keys: np.ndarray, order: int, many: int) -> np.ndarray:
    """``float32[C, many, order]`` initial parameters of the candidates of
    ``keys[C, 2]``: ``uniform(key, (order,))``, or one draw per key of
    ``split(key, many)`` when ``many > 1`` (``tracer.py:269-278``)."""
    if many == 1:
        return prng.uniform(keys, (order,))[:, None, :]
    return prng.uniform(prng.split(keys, many), (order,))


def make_groups(groups_np: dict, device) -> tuple:
    """``{order: int32[C, order]}`` -> sorted ``((order, long tensor), ...)``."""
    return tuple(
        (o, optimize.constants(torch.from_numpy(np.array(g, dtype=np.int64)).to(device)))
        for o, g in sorted(groups_np.items())
    )


def eager_chunk(pixels, fixed, walls, kind, phi, scalars, spec: EagerSpec):
    """Map of one pixel chunk: ``pixels[P, 2]``, ``fixed[F, 2]`` (the fixed
    ends), ``scalars`` = (alpha, tol, patch, r_coef, height) as floats or
    0-d tensors.  Summed over the fixed ends; differentiable."""
    alpha, tol, patch, r_coef, height = scalars
    arrays = SceneArrays(walls=walls, kind=kind, phi=phi)
    power_fun = spec.power_fun or partial(
        _received_power_batched, r_coef=r_coef, height=height
    )
    out = None
    for f in range(fixed.shape[0]):
        tx, rx = (pixels, fixed[f]) if spec.on_transmitters else (fixed[f], pixels)
        z = _accumulate_pixel(
            tx, rx, arrays, spec.groups, approx=spec.approx, alpha=alpha,
            function=spec.function, tol=tol, patch=patch, power_fun=power_fun,
            solves=spec.solves,
        )
        out = z if out is None else out + z
    if out is None:
        out = torch.zeros(pixels.shape[0], device=pixels.device)
    return out


def _requires_grad(*values) -> bool:
    return any(isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def eager_value(pixels, fixed, walls, kind, phi, scalars, spec: EagerSpec):
    """Chunked eager value map ``[P]``.

    Autograd records through it when grad mode is on and an input requires
    a gradient; otherwise the chunks run without a graph.
    """
    track = torch.is_grad_enabled() and _requires_grad(
        pixels, fixed, walls, phi, *scalars
    )
    step = spec.chunk(walls.shape[0], track)
    with torch.set_grad_enabled(track):
        parts = [
            eager_chunk(pixels[s : s + step], fixed, walls, kind, phi, scalars, spec)
            for s in range(0, pixels.shape[0], step)
        ]
    return torch.cat(parts) if parts else pixels.new_zeros(0)


def eager_value_and_grad(pixels, fixed, walls, kind, phi, scalars, spec: EagerSpec):
    """Chunked eager ``(value[P], pixel_gradient[P, 2])``.

    The pixel gradient is the autograd backward of each chunk's sum; both
    results are detached (gradient maps are terminal).
    """
    step = spec.chunk(walls.shape[0], track=True)
    vals, grads = [], []
    for start in range(0, pixels.shape[0], step):
        with torch.enable_grad():
            p = pixels[start : start + step].detach().requires_grad_(True)
            z = eager_chunk(p, fixed, walls, kind, phi, scalars, spec)
            (g,) = torch.autograd.grad(z.sum(), p)
        vals.append(z.detach())
        grads.append(g)
    if not vals:
        return pixels.new_zeros(0), pixels.new_zeros(0, 2)
    return torch.cat(vals), torch.cat(grads)


def eager_vjp(pixels, fixed, walls, kind, phi, scalars, spec: EagerSpec, g,
              needs: tuple):
    """Chunked vector-Jacobian product of :func:`eager_chunk`.

    ``scalars`` is a ``[5]`` tensor; ``needs`` says which of ``(pixels,
    fixed, walls, phi, scalars)`` want a gradient.  Returns their
    gradients (``None`` where not needed).
    """
    step = spec.chunk(walls.shape[0], track=True)
    leaves = [
        t.detach().requires_grad_(bool(n))
        for t, n in zip((fixed, walls, phi, scalars), needs[1:])
    ]
    fixed_l, walls_l, phi_l, scal_l = leaves
    totals = [None, None, None, None]
    pix_grads = []
    for start in range(0, pixels.shape[0], step):
        with torch.enable_grad():
            p = pixels[start : start + step].detach().requires_grad_(bool(needs[0]))
            z = eager_chunk(
                p, fixed_l, walls_l, kind, phi_l, tuple(scal_l.unbind()), spec
            )
            inputs = [t for t in (p, *leaves) if t.requires_grad]
            if not inputs:
                break
            outs = torch.autograd.grad(
                z, inputs, grad_outputs=g[start : start + step], allow_unused=True
            )
        it = iter(outs)
        if needs[0]:
            pix_grads.append(next(it))
        for k, leaf in enumerate(leaves):
            if leaf.requires_grad:
                gk = next(it)
                if gk is None:
                    gk = torch.zeros_like(leaf)
                totals[k] = gk if totals[k] is None else totals[k] + gk
    pix = torch.cat(pix_grads) if needs[0] and pix_grads else None
    if needs[0] and pix is None:
        pix = torch.zeros_like(pixels)
    for k, leaf in enumerate(leaves):
        if needs[k + 1] and totals[k] is None:
            totals[k] = torch.zeros_like(leaf)
    return (pix, *totals)
