"""Candidate sharding: split the path candidates, not only the pixels
(counterpart of ``differt2d_tpu/parallel/cand_sharded.py``).

The candidate count is what grows with the scene and the order (``C =
W (W - 1)^(o - 1)`` per order ``o``).  On a ``(grid, cand)`` mesh:

1. every rank holds the whole (small) scene;
2. each rank takes a contiguous share of every order's candidate rows (an
   uneven split needs no padding rows: what the ranks exchange is
   pixel-shaped) and its block of whole grid rows;
3. it maps them by the route :func:`~differt2d_tpu_torch.tracer.power_map`
   would take for those candidates (on the card the unrolled kernels B1/B2,
   or the looped kernels, each rank over its own candidates);
4. one sum all-reduce over the ``cand`` group completes each pixel, and one
   all-gather over the ``grid`` group returns the map on every rank.

Value maps are differentiable with respect to the scene: the sum's
backward passes the gradient on as it is, and the scene's tensors enter
through ``sharding.replicated``, whose backward sums their gradients over
the mesh, so every rank gets the single-device gradient of a loss computed
alike on every rank (JAX's rule for ``psum`` under ``jax.grad``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch.distributed as dist

from .. import tracer as _tracer
from ..defaults import DEFAULT_ALPHA, DEFAULT_DEVICE, DEFAULT_HEIGHT, DEFAULT_PATCH
from ..defaults import DEFAULT_R_COEF, resolve_device
from ..logic import _hard_sigmoid as hard_sigmoid
from .sharding import _GatherRows, _grids, _SumOver, local_block, pack, replicated_request, unpack


def cand_mesh(n_cand: int):
    """2-D mesh: the first dimension shards pixels, the second (``n_cand``
    ranks) candidates (:func:`~differt2d_tpu_torch.parallel.wall_grid_mesh`
    with the dimensions ``("grid", "cand")``)."""
    from .wall_sharded import wall_grid_mesh

    return wall_grid_mesh(n_cand, axis_names=("grid", "cand"))


def local_candidates(groups: dict, n: int, i: int) -> dict:
    """Share ``i`` of ``n`` of each order's candidate rows: contiguous, the
    first ``C % n`` shares one row longer; orders left without a row are
    dropped."""
    local = {o: np.array_split(g, n)[i] for o, g in groups.items()}
    return {o: g for o, g in local.items() if g.shape[0]}


def power_map_cand_sharded(
    scene,
    X,
    Y,
    *,
    mesh,
    min_order: int = 0,
    max_order: int = 1,
    order: Optional[int] = None,
    approx: Optional[bool] = None,
    alpha=DEFAULT_ALPHA,
    function=hard_sigmoid,
    tol=1e-2,
    patch=DEFAULT_PATCH,
    r_coef=DEFAULT_R_COEF,
    height=DEFAULT_HEIGHT,
    grad: bool = False,
    value_and_grad: bool = False,
    backend: str = "auto",
    device=DEFAULT_DEVICE,
) -> Any:
    """Image-method power map with pixels and candidates sharded over
    ``mesh`` (``(grid, cand)``, e.g. :func:`cand_mesh`), on every rank.

    Equal, up to the order of the sum over candidates, to
    ``power_map(..., backend=backend)`` of the same request; ``grad`` and
    ``value_and_grad`` give the pixel-gradient forms.
    """
    dev = resolve_device(device)
    grid_axis, cand_axis = mesh.mesh_dim_names
    grid_group, cand_group = mesh.get_group(grid_axis), mesh.get_group(cand_axis)
    kw = _tracer._options(dict(min_order=min_order, max_order=max_order, order=order,
                               approx=approx, alpha=alpha, function=function, tol=tol,
                               patch=patch, r_coef=r_coef, height=height), backend)
    X, Y = _grids(X, Y, dev)
    scene, X, Y, kw = replicated_request(scene.to(dev), X, Y, kw, [grid_group, cand_group])
    n_cand, rank = dist.get_world_size(cand_group), dist.get_rank(cand_group)
    every = _tracer._groups_for(scene, kw)
    # Checked alike on every rank: a rank whose map did not depend on the
    # scene would skip the backward's all-reduce and leave the others waiting.
    if not all(local_candidates(every, n_cand, i) for i in range(n_cand)):
        msg = f"{n_cand} candidate shards leave a shard without a candidate"
        raise ValueError(msg)
    groups = local_candidates(every, n_cand, rank)
    rows, cols = X.shape
    Xl, Yl = local_block(X, grid_group), local_block(Y, grid_group)
    out = _tracer.map_groups(scene, Xl, Yl, groups, kw, backend=backend, grad=grad,
                             value_and_grad=value_and_grad)
    summed = _SumOver.apply(pack(out, grad, value_and_grad), cand_group)
    whole = _GatherRows.apply(summed, grid_group)
    return unpack(whole[: rows * cols], (rows, cols), grad, value_and_grad)
