"""The order-2 city path of the port (middle segments, pair kills) against
the JAX package.

* Tables, bit for bit: on ``city_extract_scene``, ``city_scene`` and two
  seeded random cities, under hard logic, ``hard_sigmoid`` and ``sigmoid``,
  the port's ``pair_occlusion_dead`` equals the JAX package's; the 8-wall
  chunk reduction of the port's middle-segment masks equals
  ``mid_pair_masks`` and that of its first/last/line-of-sight masks equals
  ``shadow_chunk_words``; ``beam_keep_tables`` at order 2 (pair kills
  included) equals the JAX package's on a few tiles.
* Soundness (the port of ``test_pair_occlusion_dead_sound``): no pixel has
  a valid order-2 path through a pair the kill declares dead, on the port's
  eager tracer, for two 9-wall random scenes (soft and hard) and the city
  extract (at least 3000 dead pairs).
* Plain with tables equals plain with identity tables bit for bit, values
  and gradients, at orders 2 (a 24-wall random city, 10 x 10 pixels) and 3
  (12 walls, 7 x 7 pixels) under hard logic, hard_sigmoid, sigmoid, with a
  RIS and a vertex, and with two transmitters, on 4 x 4- and 3 x 3-pixel
  tiles.
* The slice: ``power_map(..., max_order=2 or 3, approx=True, device="cpu")``
  (the looped route, so the plain looped versions run) against
  ``differt2d_tpu.tracer.power_map(backend="xla")``: values at rtol 1e-4 /
  atol 1e-5, gradients under ``kink_excess(rtol=1e-3, atol=1e-5)``, on 6
  buildings of the city extract, on the whole extract and on the basic
  scene at order 3 (on a grid clear of the two pixels where XLA:CPU's
  jitted program resolves near-ties otherwise: ``test_torch_city_ties.py``
  holds those against the op-by-op run).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cull_tables import _bounds, _grid, _scene, random_city

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.ops import pallas_kernels as pk
from differt2d_tpu.rt import path_candidate_matrices
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import eager, power_map
from differt2d_tpu_torch import tracer as ttracer
from differt2d_tpu_torch.logic import hard_sigmoid
from differt2d_tpu_torch.ops import cull_tables as ct
from differt2d_tpu_torch.ops import power_map_looped as pml
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import kink_excess

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
MODES = [(True, False, 100.0), (False, False, 100.0), (True, True, 3000.0)]
f32 = jnp.float32


def _chunk_words(mask: torch.Tensor) -> np.ndarray:
    """The JAX package's 8-wall chunk reduction of a port mask."""
    return np.asarray(pk._pack_chunk_words(jnp.asarray(mask.numpy())))


def _order2_inputs(walls, tx, approx, sigmoid):
    groups = path_candidate_matrices(walls.shape[0], 0, 2)
    inputs = pml.looped_inputs({o: np.asarray(g) for o, g in groups.items()}, "cpu",
                               approx=approx, sigmoid=sigmoid)
    normals, _, imgs = pml.launch_constants(torch.from_numpy(walls), torch.from_numpy(tx), 0.0,
                                            inputs)
    return groups, normals, dict(zip(inputs.orders, imgs))


CASES = [("city_extract_scene", m) for m in range(3)] + [
    ("city_scene", 0), ("random0", 1), ("random1", 2)]

# The JAX package's table functions, each jitted whole: one compile a call
# in place of the hundreds of small ones its op-by-op run makes (about
# 20 s a scene on one CPU thread).
_pair_dead = jax.jit(pk.pair_occlusion_dead, static_argnums=(5, 6))
_mid_masks = jax.jit(pk.mid_pair_masks, static_argnums=(5,), static_argnames=("sigmoid",))
_shadow_words = jax.jit(pk.shadow_chunk_words, static_argnums=(5,),
                        static_argnames=("sigmoid",))


@pytest.mark.parametrize("name,mode", CASES)
def test_order2_tables_equal_the_jax_package(name, mode, monkeypatch):
    walls, kind, tx = _scene(name)
    approx, sig, alpha = MODES[mode]
    W = walls.shape[0]
    jw, jk, jtx = jnp.asarray(walls), jnp.asarray(kind), jnp.asarray(tx)
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    # Kill of wall pairs, in one slab and in slabs of 7 downstream walls.
    ref = np.asarray(_pair_dead(jw, jk, jtx, f32(0.0), f32(alpha), approx, sig, f32(1e-2)))
    dead = ct.pair_occlusion_dead(tw, tk, ttx, 0.0, alpha, approx, sig, 1e-2)
    np.testing.assert_array_equal(dead.numpy(), ref)
    assert 1000 < int(dead.sum()) < W * W // 2
    if mode == 0:
        monkeypatch.setattr(ct, "_PAIR_CHUNK", 7 * W * W)
        np.testing.assert_array_equal(
            ct.pair_occlusion_dead(tw, tk, ttx, 0.0, alpha, approx, sig, 1e-2).numpy(), ref)
    # Middle-segment masks and their kernel words; first/last/LOS masks.
    X, Y = _grid()
    tb = _bounds(X, Y, (8, 8))
    jb = [jnp.asarray(t.numpy()) for t in tb]
    geo = ct._shadow_geometry(tw, tk, ttx, 0.0, alpha, approx, sig, 1e-2)
    mid = ct.mid_masks(geo)
    np.testing.assert_array_equal(
        _chunk_words(mid).reshape(-1),
        np.asarray(_mid_masks(jw, jk, jtx, f32(0.0), f32(alpha), approx, sigmoid=sig,
                              tol=f32(1e-2))))
    assert 0.1 < float(mid.float().mean()) < 0.5
    words = ct.mid_words(geo)
    assert words.shape == (W * W, -(-W // 32))
    assert torch.equal(ct.unpack_words(words, W).reshape(W, W, W), mid)
    _, m0, mlast, mlos = ct._occluder_masks(tw, tk, ttx, 0.0, alpha, approx, *tb, sigmoid=sig,
                                            tol=1e-2, geo=geo)
    l0w, lastw, losw = _shadow_words(jw, jk, jtx, f32(0.0), f32(alpha), approx, *jb,
                                     sigmoid=sig, tol=f32(1e-2))
    assert bool(geo["hz_free"])
    np.testing.assert_array_equal(_chunk_words(m0), np.asarray(l0w))
    np.testing.assert_array_equal(_chunk_words(mlast), np.asarray(lastw)[:, 0])
    np.testing.assert_array_equal(_chunk_words(mlos), np.asarray(losw)[:, 0, 0])
    # Keep tables at order 2 (beam proof, first-wall and pair kills) on
    # four tiles of the 32 x 32 grid.
    groups, normals, imgs = _order2_inputs(walls, tx, approx, sig)
    sub = [t[[0, 5, 10, 15]] for t in tb]
    jkeep = jax.jit(lambda jw, normals, jk, img, *sub: pk.beam_keep_tables(
        jw, normals, jk, groups, [2], {2: img}, *sub, approx=approx, alpha=f32(alpha), tx=jtx,
        patch=f32(0.0), occlusion=False, refine=4, sigmoid=sig, tol=f32(1e-2),
    )[2])(jw, jnp.asarray(normals.numpy()), jk, jnp.asarray(imgs[2].numpy()),
          *(jnp.asarray(t.numpy()) for t in sub))
    tkeep = ct.beam_keep_tables(tw, normals, tk, groups, [2], imgs, *sub, approx=approx,
                                alpha=alpha, tx=ttx, patch=0.0, refine=4, sigmoid=sig,
                                tol=1e-2)[2]
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert 0.0 < float(tkeep.float().mean()) < 0.2


def test_hazard_gate_lists_every_wall_on_middle_segments():
    walls, kind, tx = _scene("city_extract_scene")
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    geo = ct._shadow_geometry(tw, tk, ttx, 0.0, 2.0, True, False, 1e-2)
    assert not bool(geo["hz_free"])
    assert bool(ct.mid_masks(geo, slice(0, 3)).all())
    assert not bool(ct.pair_occlusion_dead(tw, tk, ttx, 0.0, 2.0, True, False, 1e-2).any())


def _dead_pair_paths_valid(walls, kind, tx, dead, n, approx, lo=0.02, hi=0.98):
    """Whether some pixel of an n x n grid has a valid order-2 path through
    a dead pair (the port's eager tracer, only the dead pairs' candidates)."""
    cand = torch.nonzero(dead)
    arrays = eager.SceneArrays(walls=torch.from_numpy(walls), kind=torch.from_numpy(kind),
                               phi=torch.zeros(walls.shape[0]))
    x = np.linspace(lo, hi, n, dtype=np.float32)
    X, Y = np.meshgrid(x, x)
    pix = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], -1)).reshape(-1, 1, 2)
    _, _, valid = eager._trace_group(
        torch.from_numpy(tx).reshape(1, 1, 2), pix, arrays, 2, cand, approx=approx,
        alpha=100.0, function=hard_sigmoid, tol=1e-2, patch=0.0,
    )
    return bool((valid > 0).any())


@pytest.mark.parametrize("seed,n,approx", [(17, 5, True), (18, 4, False)])
def test_pair_occlusion_dead_sound_on_random_scenes(seed, n, approx):
    js = JScene.random_uniform_scene(n_walls=9, key=jax.random.PRNGKey(seed))
    walls = np.array(jtracer.scene_arrays(js).walls, np.float32)
    tx = np.array(next(iter(js.transmitters.values())).xy, np.float32)
    kind = np.zeros(9, np.int32)
    dead = ct.pair_occlusion_dead(torch.from_numpy(walls), torch.from_numpy(kind),
                                  torch.from_numpy(tx), 0.0, 100.0, approx, False, 1e-2)
    if bool(dead.any()):
        assert not _dead_pair_paths_valid(walls, kind, tx, dead, n, approx)


def test_pair_occlusion_dead_sound_on_the_city_extract():
    walls, kind, tx = _scene("city_extract_scene")
    dead = ct.pair_occlusion_dead(torch.from_numpy(walls), torch.from_numpy(kind),
                                  torch.from_numpy(tx), 0.0, 100.0, True, False, 1e-2)
    assert int(dead.sum()) >= 3000
    assert not _dead_pair_paths_valid(walls, kind, tx, dead, 4, True)


# -- plain culled against plain unculled ---------------------------------------------


def _random_scene(case, order):
    """A seeded random city: 6 buildings (24 walls) at order 2, 3 (12 walls)
    at order 3, with the case's extra objects."""
    walls, _, tx = random_city(3, 6 if order == 2 else 3)
    scene = Scene.from_arrays(walls, transmitters={"tx": tx}, receivers={"rx": [0.5, 0.5]},
                              device="cpu")
    if case == "ris_vertex":
        scene = scene.add_ris([[0.4, 0.05], [0.6, 0.05]]).add_vertex([0.5, 0.97])
    elif case == "two_tx":
        scene = scene.update_transmitters(tx2=[0.93, 0.08])
    return scene


@pytest.mark.parametrize("case", ["hard", "hard_sigmoid", "sigmoid", "ris_vertex", "two_tx"])
@pytest.mark.parametrize("order", [2, 3])
def test_plain_tables_equal_identity_tables_at_higher_orders(order, case):
    scene = _random_scene(case, order)
    approx, sig = case != "hard", case == "sigmoid"
    alpha = 3000.0 if sig else 100.0
    # Ragged edge tiles; 7 x 7 pixels in 3 x 3 tiles at order 3 (1,452
    # candidates of order 3).
    x = np.linspace(0.02, 0.98, 10 if order == 2 else 7, dtype=np.float32)
    X, Y = (torch.from_numpy(a) for a in np.meshgrid(x, x))
    groups = path_candidate_matrices(scene.num_objects, 0, order)
    inputs = pml.looped_inputs({o: np.asarray(g) for o, g in groups.items()}, "cpu",
                               approx=approx, sigmoid=sig)
    assert inputs.orders == tuple(range(1, order + 1))
    txs = torch.stack(list(scene.transmitters.values()))
    scal = (alpha, 1e-2, 0.0, 0.5, 0.1)
    outs = {}
    for on in (True, False):
        plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs, approx=approx,
                             sigmoid=sig, cull=on, shadow=on, tile=(4, 4) if order == 2 else (3, 3))
        args = (X.reshape(-1), Y.reshape(-1), scene.walls, scene.kind, scene.phi, scal, inputs,
                plan)
        outs[on] = (pml.plain_looped_value(*args), *pml.plain_looped_value_and_grad(*args))
        if on:
            tb = plan.per_tx[0].tables
            kept = float(tb.cnt[-1].sum()) / tb.prm[-1].numel()
            listed = float(ct.unpack_words(tb.midw, scene.num_objects).float().mean())
            assert kept < 0.3 and listed < 0.6, (kept, listed)
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    assert float(outs[True][0].abs().sum()) > 0.0


# -- the slice against the JAX package -------------------------------------------------


def _extract(n_buildings=None):
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "data", "city_extract.geojson")) as f:
        features = json.load(f)["features"]
    text = json.dumps({"type": "FeatureCollection", "features": features[:n_buildings]})
    return JScene.from_geojson(text), Scene.from_geojson(text.encode(), device="cpu")


def _match_jax(js, ts, X, Y, kw, grad_grid=None):
    """The port's map (looped route) against the JAX XLA tracer's; the
    gradient on ``grad_grid`` (default: the same grid, where one JAX
    value-and-gradient map is the reference of both port maps)."""
    for grad in (False, True):
        ok, reason = ttracer._kernel_eligible(ts, kw, grad=grad)
        assert ok and reason.startswith("looped"), reason
    gX, gY = (X, Y) if grad_grid is None else grad_grid
    rv, rg = jtracer.power_map(js, jnp.asarray(gX), jnp.asarray(gY), backend="xla",
                               value_and_grad=True, **kw)
    ref = rv if grad_grid is None else jtracer.power_map(
        js, jnp.asarray(X), jnp.asarray(Y), backend="xla", **kw)
    got = power_map(ts, torch.from_numpy(X), torch.from_numpy(Y), device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(got.sum()) > 0.0
    zv, zg = power_map(ts, torch.from_numpy(gX), torch.from_numpy(gY), device="cpu",
                       value_and_grad=True, **kw)
    np.testing.assert_allclose(zv.numpy(), np.asarray(rv), **TOL)
    n_bad, allowed = kink_excess(zg, np.asarray(rg), rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed, (n_bad, allowed)
    assert float(zg.abs().sum()) > 0.0


def test_six_buildings_at_order_2_match_jax():
    js, ts = _extract(6)
    X, Y = _grid(12, 0.03, 0.97)
    _match_jax(js, ts, X, Y, dict(max_order=2, approx=True))


def test_city_extract_at_order_2_matches_jax():
    """The slice itself, at 18,497 candidates: the value map on 6 x 6
    pixels, the gradient on 2 x 2 (the plain version runs every candidate
    of every pixel on the CPU, most of a second a pixel)."""
    js, ts = _extract()
    _match_jax(js, ts, *_grid(6, 0.03, 0.97), dict(max_order=2, approx=True),
               grad_grid=_grid(2, 0.2, 0.8))


def test_basic_scene_at_order_3_matches_jax():
    x = np.linspace(0.06, 0.94, 16, dtype=np.float32)
    y = np.linspace(0.07, 0.93, 9, dtype=np.float32)
    X, Y = np.meshgrid(x, y)
    _match_jax(JScene.basic_scene(), Scene.basic_scene(device="cpu"), X, Y,
               dict(max_order=3, approx=True))
