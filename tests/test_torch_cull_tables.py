"""The port's culling tables against the JAX package's.

Equality: on ``city_scene``, ``city_extract_scene`` and two seeded random
cities, with the tile boxes of a 32 x 32 grid in 8 x 8 tiles, the port's
``first_wall_visibility_dead``, ``beam_keep_tables`` (refine 8; the JAX side
with ``occlusion=False``), ``_occluder_masks`` and ``shadow_wall_lists``
equal the JAX package's arrays, under hard logic, ``hard_sigmoid`` and
``sigmoid``; also on a random city with walls of lengths 2^-20 to 2^-62,
above the port's short-wall rule (``cull_tables._FLT_MIN``), which is the
one place where its tables may differ from the JAX package's (walls whose
squared length is not a normal float32); ``_span_covered`` too, on random
intervals.
Their soundness is ``tests/test_torch_cull_soundness.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.ops import pallas_kernels as pk
from differt2d_tpu.rt import path_candidate_matrices
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch.ops import cull_tables as ct
from differt2d_tpu_torch.ops import power_map_looped as pml

torch.set_num_threads(1)

MODES = [(True, False, 100.0), (False, False, 100.0), (True, True, 3000.0)]


def random_city(seed: int, n_buildings: int = 12):
    """Rotated rectangular buildings (4 walls each) and a transmitter,
    from a NumPy seed."""
    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(n_buildings):
        cx, cy = rng.uniform(0.1, 0.9, 2)
        w, h = rng.uniform(0.03, 0.12, 2)
        c, s = np.cos(rng.uniform(0, np.pi)), np.sin(rng.uniform(0, np.pi))
        pts = [(cx + c * dx - s * dy, cy + s * dx + c * dy)
               for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h))]
        walls += [[pts[i - 1], pts[i]] for i in range(4)]
    return (np.asarray(walls, np.float32), np.zeros(len(walls), np.int32),
            rng.uniform(0.05, 0.95, 2).astype(np.float32))


def _scene(name):
    if name == "short walls":
        # random0 with its last building's four walls replaced by walls from
        # the origin (where float32 holds such lengths) of lengths about
        # 2^-20, 2^-40, 2^-60 and 2^-62: above the port's short-wall cut
        # (|d|^2 a normal float32), so its tables stay the JAX package's.
        walls, kind, tx = random_city(0, 34)
        length = 2.0 ** -np.array([20, 40, 60, 62])[:, None]
        ends = length * np.array([[1.0, 0.5], [0.5, 1.0], [1.0, -0.5], [-0.5, 1.0]])
        walls[-4:] = np.stack([np.zeros_like(ends), ends], axis=1).astype(np.float32)
        return walls, kind, tx
    if name.startswith("random"):
        # As many walls as the two city scenes (136, 120): the JAX side
        # compiles its ops once per shape.
        seed = int(name[-1])
        return random_city(seed, (34, 30)[seed])
    js = getattr(JScene, name)()
    arr = jtracer.scene_arrays(js)
    return (np.array(arr.walls), np.array(arr.kind),
            np.array(js.transmitters["tx"].xy))


def _grid(n=32, lo=0.02, hi=0.98):
    x = np.linspace(lo, hi, n, dtype=np.float32)
    return np.meshgrid(x, x)


def _bounds(X, Y, tile):
    return pml.tile_bounds(torch.from_numpy(X), torch.from_numpy(Y), tile)


CASES = [("city_extract_scene", m) for m in range(3)] + [
    ("city_scene", 0), ("random0", 1), ("random1", 2), ("short walls", 1)]


@pytest.mark.parametrize("name,mode", CASES)
def test_tables_equal_the_jax_package(name, mode):
    walls, kind, tx = _scene(name)
    X, Y = _grid()
    tb = _bounds(X, Y, (8, 8))
    jb = [jnp.asarray(t.numpy()) for t in tb]
    W = walls.shape[0]
    groups = path_candidate_matrices(W, 0, 1)
    jw, jk, jtx = jnp.asarray(walls), jnp.asarray(kind), jnp.asarray(tx)
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    for approx, sig, alpha in MODES[mode:mode + 1]:
        inputs = pml.looped_inputs(groups, "cpu", approx=approx, sigmoid=sig)
        normals, _, (img,) = pml.launch_constants(tw, ttx, 0.0, inputs)
        f32 = jnp.float32
        dead = pk.first_wall_visibility_dead(jw, jk, jtx, f32(0.0), f32(alpha), approx, sig,
                                             f32(1e-2))
        np.testing.assert_array_equal(
            ct.first_wall_visibility_dead(tw, tk, ttx, 0.0, alpha, approx, sig, 1e-2).numpy(),
            np.asarray(dead))
        jkeep = pk.beam_keep_tables(
            jw, jnp.asarray(normals.numpy()), jk, groups, [1],
            {1: jnp.asarray(img.numpy())}, *jb, approx=approx, alpha=f32(alpha),
            tx=jtx, patch=f32(0.0), occlusion=False, refine=8, sigmoid=sig, tol=f32(1e-2),
        )[1]
        tkeep = ct.beam_keep_tables(
            tw, normals, tk, groups, [1], {1: img}, *tb, approx=approx,
            alpha=alpha, tx=ttx, patch=0.0, refine=8, sigmoid=sig, tol=1e-2,
        )[1]
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        assert 0.0 < float(tkeep.float().mean()) < 0.75
        for got, ref in zip(
            ct._occluder_masks(tw, tk, ttx, 0.0, alpha, approx, *tb, sigmoid=sig, tol=1e-2)[1:],
            pk._occluder_masks(jw, jk, jtx, f32(0.0), f32(alpha), approx, *jb, sigmoid=sig,
                               tol=f32(1e-2))[1:],
        ):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        lists = ct.shadow_wall_lists(tw, tk, ttx, 0.0, alpha, approx, *tb, sigmoid=sig, tol=1e-2)
        ref = pk.shadow_wall_lists(jw, jk, jtx, f32(0.0), f32(alpha), approx, *jb, sigmoid=sig,
                                   tol=f32(1e-2))
        for got, r in zip(lists, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(r))


def test_span_covered_equals_the_jax_package():
    rng = np.random.default_rng(5)
    starts = rng.uniform(-0.3, 1.1, (64, 9)).astype(np.float32)
    ends = (starts + rng.uniform(-0.05, 0.6, (64, 9))).astype(np.float32)
    empty = rng.uniform(size=(64, 9)) < 0.2
    starts[empty], ends[empty] = np.inf, -np.inf
    starts[:, 3] = starts[:, 2]  # ties of starts
    for lo, hi in ((-0.02, 1.02), (0.0, 1.0), (0.3, 0.4)):
        got = ct._span_covered(torch.from_numpy(starts), torch.from_numpy(ends),
                               np.float32(lo), np.float32(hi))
        ref = pk._span_covered(jnp.asarray(starts), jnp.asarray(ends),
                               jnp.float32(lo), jnp.float32(hi))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert 0 < int(got.sum()) < 64


def test_tables_in_the_kernels_form():
    walls, kind, tx = _scene("city_extract_scene")
    tw, tk, ttx = torch.from_numpy(walls), torch.from_numpy(kind), torch.from_numpy(tx)
    X, Y = _grid(24)
    tb = _bounds(X, Y, (8, 8))
    W = walls.shape[0]
    l0dat, l0cnt, ldat, lcnt, sdat, scnt = ct.shadow_wall_lists(tw, tk, ttx, 0.0, 100.0, True, *tb)
    geo = ct._shadow_geometry(tw, tk, ttx, 0.0, 100.0, True, False, None)
    words = ct.pack_words(ct.last_masks(geo, *tb))
    assert words.dtype == torch.int32 and words.shape == (9, W, 5)
    unpacked = ct.unpack_words(words, W)
    for t in range(9):
        for w in range(W):
            n = int(lcnt[t, 0, w])
            assert sorted(torch.nonzero(unpacked[t, w]).ravel().tolist()) == \
                sorted(ldat[t, w, :n].tolist())
    rng = np.random.default_rng(1)
    keep = torch.from_numpy(rng.uniform(size=(7, 11)) < 0.4)
    prm, cnt = ct.keep_lists(keep)
    assert cnt.tolist() == keep.sum(1).tolist()
    for t in range(7):
        assert prm[t, : cnt[t]].tolist() == torch.nonzero(keep[t]).ravel().tolist()
    assert torch.equal(pml._keep_mask(prm, cnt), keep)
