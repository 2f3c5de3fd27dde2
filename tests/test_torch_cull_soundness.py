"""Soundness of the port's culling tables against the eager tracer.

The port of ``tests/test_pallas.py``'s
``test_beam_keep_tables_prune_and_protect``,
``test_shadow_wall_lists_shapes_and_soundness`` and
``test_first_wall_visibility_dead_sound``, checked on the pixels themselves
with the eager tracer's per-candidate results: a (tile, candidate) the
tables drop contributes exactly 0, with an exactly-0 pixel gradient, at
every pixel of the tile; a wall off a segment's occluder list has a hit of
exactly 0 wherever the candidate's validity is not exactly 0; no pixel has a
valid path through a dead first wall.
"""

import numpy as np
import pytest
import torch
from test_torch_cull_tables import _bounds, _grid, _scene

from differt2d_tpu.rt import path_candidate_matrices
from differt2d_tpu_torch import eager
from differt2d_tpu_torch.logic import hard_sigmoid, sigmoid
from differt2d_tpu_torch.ops import cull_tables as ct
from differt2d_tpu_torch.ops import geometry_ops
from differt2d_tpu_torch.ops import power_map_looped as pml

torch.set_num_threads(1)


def _per_candidate(walls, kind, tx, X, Y, approx, function, alpha=100.0):
    """Eager order-1 results per pixel and candidate: ``(pts_full, valid,
    contribution, d contribution / d pixel weighted by random positive
    weights)``."""
    arrays = eager.SceneArrays(walls=torch.from_numpy(walls), kind=torch.from_numpy(kind),
                               phi=torch.zeros(walls.shape[0]))
    cand = torch.arange(walls.shape[0])[:, None]
    pix = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], -1)).requires_grad_(True)
    pts, _, valid = eager._trace_group(
        torch.from_numpy(tx).reshape(1, 1, 2), pix.reshape(-1, 1, 2), arrays, 1, cand,
        approx=approx, alpha=alpha, function=function, tol=1e-2, patch=0.0,
    )
    c = valid * eager._received_power_batched(pts, 1, 0.5, 0.1)
    return pts.detach(), valid.detach(), c, pix


@pytest.mark.parametrize("name", ["city_extract_scene", "random1"])
def test_beam_keep_tables_drop_only_exact_zeros(name):
    walls, kind, tx = _scene(name)
    X, Y = _grid(12)
    tile = (4, 4)
    tb = _bounds(X, Y, tile)
    groups = path_candidate_matrices(walls.shape[0], 0, 1)
    inputs = pml.looped_inputs(groups, "cpu", approx=True, sigmoid=False)
    tw, ttx = torch.from_numpy(walls), torch.from_numpy(tx)
    normals, _, (img,) = pml.launch_constants(tw, ttx, 0.0, inputs)
    keep = ct.beam_keep_tables(tw, normals, torch.from_numpy(kind), groups, [1],
                               {1: img}, *tb, approx=True, alpha=100.0, tx=ttx,
                               patch=0.0, refine=8, tol=1e-2)[1]
    assert float(keep.float().mean()) < 0.75, "the tables prune nothing"
    plan = pml.Plan(rows=12, cols=12, tile=tile, per_tx=())
    tile_of = plan.tile_of(torch.arange(12 * 12))
    _, _, c, pix = _per_candidate(walls, kind, tx, X, Y, True, hard_sigmoid)
    dropped = ~keep[tile_of]
    assert bool((c.detach()[dropped] == 0).all())
    weights = torch.rand(c.shape, generator=torch.Generator().manual_seed(0)) + 0.5
    (g,) = torch.autograd.grad((c * weights * dropped).sum(), pix)
    assert bool((g == 0).all())
    kept_any = (c.detach() != 0) & keep[tile_of]
    assert bool(kept_any.any())
    # Vertex-last protection: with every wall a vertex, nothing is dropped
    # by the beam proof.
    vtx = torch.full_like(torch.from_numpy(kind), 2)
    keep_v = ct.beam_keep_tables(tw, normals, vtx, groups, [1], {1: img}, *tb,
                                 approx=True, alpha=100.0, refine=8)[1]
    assert bool(keep_v.all())


@pytest.mark.parametrize("approx", [True, False])
def test_occluder_lists_drop_only_zero_hits(approx):
    walls, kind, tx = _scene("city_extract_scene")
    X, Y = _grid(16, 0.05, 0.95)
    tile = (4, 4)
    tb = _bounds(X, Y, tile)
    W = walls.shape[0]
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    geo, m0, mlast, mlos = ct._occluder_masks(tw, tk, ttx, 0.0, 100.0, approx, *tb, tol=1e-2)
    assert bool(geo["hz_free"]) and float(mlast.float().mean()) < 0.5
    plan = pml.Plan(rows=16, cols=16, tile=tile, per_tx=())
    tile_of = plan.tile_of(torch.arange(256))
    pts, valid, _, _ = _per_candidate(walls, kind, tx, X, Y, approx, hard_sigmoid)
    alive = valid != 0  # [P, C]
    w0 = torch.arange(W)
    listed = torch.stack([m0[w0][None].expand(256, -1, -1), mlast[tile_of][:, w0]], dim=2)
    a, b = tw[:, 0], tw[:, 1]
    for s in (0, 1):
        hit = geometry_ops.segments_intersect(
            a, b, pts[:, :, s, None, :], pts[:, :, s + 1, None, :], approx=approx,
            alpha=100.0, function=hard_sigmoid,
        )  # [P, C, W]
        off = ~listed[:, :, s] & (w0[None, None, :] != w0[None, :, None])
        assert not bool((off & (hit != 0) & alive[:, :, None]).any()), s
    # Line of sight: TX -> pixel, no bounce, no gate.
    pix = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], -1))
    hit = geometry_ops.segments_intersect(a, b, ttx.expand(256, 2)[:, None], pix[:, None],
                                          approx=approx, alpha=100.0, function=hard_sigmoid)
    assert not bool((~mlos[tile_of] & (hit != 0)).any())
    assert float(mlos.float().mean()) < 0.9


@pytest.mark.parametrize("name", ["random0", "random1", "city_extract_scene"])
def test_first_wall_visibility_dead_sound(name):
    walls, kind, tx = _scene(name)
    dead = ct.first_wall_visibility_dead(torch.from_numpy(walls), torch.from_numpy(kind),
                                         torch.from_numpy(tx), 0.0, 100.0, True, False, 1e-2)
    X, Y = _grid(12, 0.015, 0.985)
    for approx in (True, False):
        _, valid, _, _ = _per_candidate(walls, kind, tx, X, Y, approx, hard_sigmoid)
        assert not bool(((valid > 0) & dead[None, :]).any())
    if name == "city_extract_scene":
        assert int(dead.sum()) >= 40
    dead_s = ct.first_wall_visibility_dead(torch.from_numpy(walls), torch.from_numpy(kind),
                                           torch.from_numpy(tx), 0.0, 3000.0, True, True, 1e-2)
    _, valid, _, _ = _per_candidate(walls, kind, tx, X, Y, True, sigmoid, alpha=3000.0)
    assert not bool(((valid > 0) & dead_s[None, :]).any())


def test_hazard_gate_falls_back_to_every_wall():
    walls, kind, tx = _scene("city_extract_scene")
    W = walls.shape[0]
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    box = [torch.tensor([v]) for v in (0.0, 0.5, 0.0, 0.5)]
    _, l0cnt, _, lcnt, _, _ = ct.shadow_wall_lists(tw, tk, ttx, 0.0, 100.0, True, *box, tol=1e-2)
    assert float(l0cnt.float().mean()) < W
    _, l0cnt, _, lcnt, _, _ = ct.shadow_wall_lists(tw, tk, ttx, 0.0, 2.0, True, *box, tol=1e-2)
    assert bool((l0cnt == W).all() and (lcnt == W).all())
    _, l0cnt, _, _, _, _ = ct.shadow_wall_lists(tw, tk, ttx, 0.0, 100.0, False, *box, tol=2.0)
    assert bool((l0cnt == W).all())
