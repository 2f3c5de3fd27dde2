"""Wall sharding: the order <= 1 map with the wall axis split over ranks
(counterpart of ``differt2d_tpu/parallel/wall_sharded.py``).

:func:`~differt2d_tpu_torch.parallel.power_map_sharded` splits the pixels.
For scenes with many walls the per-pixel cost itself is O(candidates x
walls), most of it the blocked test, so this module also splits the wall
axis over a second mesh dimension:

1. each rank solves the bounce points of its **candidate shard** (order-1
   candidates align 1:1 with walls, so candidates shard with walls);
2. the bounce points are all-gathered over the wall group (C x 2 per
   pixel);
3. each rank tests every candidate's segments against its **local walls**
   only: the O(C x W x pixels) work, split W-ways;
4. a MAX all-reduce over the wall group (a soft OR is a max) completes the
   blocked test, every rank of the group then holds the whole candidate
   sum, and one all-gather over the grid group returns the map.

Scope, as in the JAX package: order <= 1 on wall-only scenes, forward maps
(computed without autograd).  Like the JAX module it runs no kernel: its
operations are PyTorch's, on the rank's device.  The candidate-sharded map
(:func:`~differt2d_tpu_torch.parallel.power_map_cand_sharded`) takes any
order, mixed objects and gradients with one collective less.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import logic
from .._runtime_typing import unchecked
from ..defaults import (
    DEFAULT_ALPHA,
    DEFAULT_DEVICE,
    DEFAULT_HEIGHT,
    DEFAULT_PATCH,
    DEFAULT_R_COEF,
    KIND_WALL,
    resolve_device,
)
from ..logic import _hard_sigmoid as hard_sigmoid
from ..ops import geometry_ops as _ops
from .sharding import _grids, _require_initialized, all_gather, all_reduce, local_block
from .sharding import mesh_device_type


def wall_grid_mesh(n_wall: int, axis_names: tuple[str, str] = ("grid", "wall")):
    """2-D mesh over every rank: the first dimension shards pixels, the
    second (``n_wall`` ranks) walls.  Needs an initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_initialized()
    world = dist.get_world_size()
    n_grid = world // n_wall
    if n_wall < 1 or n_grid * n_wall != world:
        msg = f"{world} ranks do not factor as n_grid x {n_wall}"
        raise ValueError(msg)
    return init_device_mesh(mesh_device_type(), (n_grid, n_wall), mesh_dim_names=axis_names)


def power_map_wall_sharded(
    scene,
    X,
    Y,
    *,
    mesh,
    max_order: int = 1,
    approx: Optional[bool] = None,
    alpha=DEFAULT_ALPHA,
    function=hard_sigmoid,
    tol=1e-2,
    patch=DEFAULT_PATCH,
    r_coef=DEFAULT_R_COEF,
    height=DEFAULT_HEIGHT,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Received-power map with pixels and walls sharded over ``mesh``
    (``(grid, wall)``, e.g. :func:`wall_grid_mesh`), equal within rounding
    to ``power_map(..., max_order=max_order, backend="torch")`` on
    wall-only scenes; the map is on every rank."""
    dev = resolve_device(device)
    function = unchecked(function)
    if approx is None:
        approx = logic.ENABLE_APPROX
    if max_order > 1:
        msg = "wall-sharded maps support max_order <= 1"
        raise ValueError(msg)
    scene = scene.to(dev)
    if any(k != KIND_WALL for k in scene.kinds):
        msg = "wall-sharded maps require wall-only scenes"
        raise ValueError(msg)
    grid_axis, wall_axis = mesh.mesh_dim_names
    grid_group, wall_group = mesh.get_group(grid_axis), mesh.get_group(wall_axis)
    n_shards = dist.get_world_size(wall_group)
    # Pad the wall axis to a shard multiple with zero-length walls: they
    # never block (zero denominator) and their candidate rows are masked.
    W = scene.num_objects
    W_pad = -(-W // n_shards) * n_shards
    walls = torch.cat([scene.walls.detach(), torch.zeros(W_pad - W, 2, 2, device=dev)])
    wall_valid = (torch.arange(W_pad, device=dev) < W).to(torch.float32)
    w_loc = W_pad // n_shards
    base = dist.get_rank(wall_group) * w_loc
    walls_loc = walls[base : base + w_loc]

    X, Y = _grids(X, Y, dev)
    pix = torch.stack([local_block(X, grid_group).reshape(-1),
                       local_block(Y, grid_group).reshape(-1)], dim=-1)
    soft = bool(approx)

    def segments_hit(seg_a, seg_b):
        """Soft/hard hit of segments ``[C, P, 2]`` with the local walls:
        ``[w_loc, C, P]``."""
        w_dir = walls_loc[:, 1, :] - walls_loc[:, 0, :]
        wa = (walls_loc[:, 0, :] - patch * w_dir)[:, None, None, :]
        wb = (walls_loc[:, 1, :] + patch * w_dir)[:, None, None, :]
        return _ops.segments_intersect(wa, wb, seg_a[None], seg_b[None], approx=soft,
                                       alpha=alpha, function=function)

    def blocked_over_walls(hits):
        """The blocked test over every wall from the local walls' hits,
        reduced over the first axis."""
        if soft:
            return all_reduce(torch.amax(hits, dim=0), wall_group, dist.ReduceOp.MAX)
        part = torch.any(hits, dim=0).to(torch.float32)
        return all_reduce(part, wall_group, dist.ReduceOp.MAX) > 0.5

    eps = torch.finfo(torch.float32).eps
    with torch.no_grad():
        acc = torch.zeros(pix.shape[0], device=dev)
        for tx in scene.transmitters.values():
            tx = tx.detach()
            if max_order >= 1:
                # Bounce points of the local candidates: [w_loc, P, 2].
                images = _ops.mirror_point(tx, walls_loc)
                normal = _ops.wall_normal(walls_loc)
                u = pix[None, :, :] - images[:, None, :]
                un = torch.sum(u * normal[:, None, :], dim=-1)
                vn = torch.sum((walls_loc[:, None, 0, :] - pix[None, :, :]) * normal[:, None, :],
                               dim=-1)
                un_zero = un == 0.0
                s = torch.where(un_zero, torch.zeros_like(un),
                                vn / torch.where(un_zero, torch.ones_like(un), un))
                bounce = pix[None] + s[..., None] * u
                # Every candidate's bounce points, on every rank of the
                # wall group: [C = W_pad, P, 2].
                bounce_all = all_gather(bounce, wall_group)
                C = bounce_all.shape[0]
                tx_tile = tx.expand(bounce_all.shape)
                pix_tile = pix[None].expand(bounce_all.shape)

                # Blocked: local walls against both segments of every
                # candidate, the candidate's own wall left out.
                hits1 = segments_hit(tx_tile, bounce_all)
                hits2 = segments_hit(bounce_all, pix_tile)
                own = ((base + torch.arange(w_loc, device=dev))[:, None]
                       == torch.arange(C, device=dev)[None, :])
                if soft:
                    hits = torch.where(own[..., None], 0.0, torch.maximum(hits1, hits2))
                else:
                    hits = (hits1 | hits2) & ~own[..., None]
                blocked = blocked_over_walls(hits)

                # On the candidate's own wall, and its specular residual.
                t_par = _ops.cartesian_to_parametric(walls[:, None, :, :], bounce_all)
                loss = _ops.specular_residual(tx_tile, bounce_all, pix_tile, walls[:, None, :, :])
                if soft:
                    on = torch.minimum(function(t_par, alpha), function(1.0 - t_par, alpha))
                    valid = torch.nan_to_num(torch.minimum(torch.minimum(on, 1.0 - blocked),
                                                           function(tol - loss, alpha)))
                else:
                    on = (t_par >= 0.0) & (t_par <= 1.0)
                    valid = on & ~blocked & (loss < tol)
                r = _ops.path_length(torch.stack([tx_tile, bounce_all, pix_tile], dim=-2))
                power = r_coef / (height * height + r * r)
                acc = acc + torch.sum(valid * power * wall_valid[:, None], dim=0)

            # Order 0 (line of sight): blocked over the local walls, then
            # the MAX over the wall group.
            hits = segments_hit(tx.expand(pix.shape)[None], pix[None])[:, 0, :]
            blocked0 = blocked_over_walls(hits)
            if soft:
                loss_ok0 = function(torch.as_tensor(tol, dtype=torch.float32, device=dev), alpha)
                valid0 = torch.nan_to_num(torch.minimum(1.0 - blocked0, loss_ok0))
            else:
                valid0 = ~blocked0
            d = pix - tx
            r0 = torch.sqrt((d[:, 0] + eps) ** 2 + (d[:, 1] + eps) ** 2)
            acc = acc + valid0 * (1.0 / (height * height + r0 * r0))
        flat = all_gather(acc, grid_group)
    return flat[: X.numel()].reshape(X.shape)
