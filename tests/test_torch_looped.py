"""The city path of the port: scenes, dispatch, the looped kernels' plain
versions with and without their tables, and the slice against the JAX
package.

* Scenes: ``from_geojson``, ``city_scene`` and ``city_extract_scene`` give
  the JAX factories' walls, transmitters and receivers, from a byte-identical
  copy of the geojson.
* Plain culled against plain unculled: ``plain_looped_value`` and
  ``plain_looped_value_and_grad`` with the culling tables equal the same
  functions with identity tables bit for bit (both city scenes, hard logic,
  hard_sigmoid, sigmoid, a RIS and a vertex, two transmitters, a transmitter
  grid), on 4 x 4-pixel tiles so that the tables drop most of the work.
* The slice: ``power_map(city, 16 x 16, max_order=1, approx=True,
  device="cpu")`` (the looped route, so the plain looped version runs)
  against ``differt2d_tpu.tracer.power_map(backend="xla")``: values at rtol
  1e-4 / atol 1e-5, gradients under ``kink_excess(rtol=1e-3, atol=1e-5)``;
  autograd of the map's sum with respect to the walls and the transmitter
  against ``jax.grad`` at 8 x 8 (6 buildings of the city extract).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cull_tables import random_city

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import Point
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import TypeCheckError, power_map
from differt2d_tpu_torch import tracer as ttracer
from differt2d_tpu_torch.logic import sigmoid
from differt2d_tpu_torch.ops import power_map_looped as pml
from differt2d_tpu_torch.rt import path_candidate_matrices
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import kink_excess

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


def _grid(n, lo=0.05, hi=0.95):
    x = np.linspace(lo, hi, n, dtype=np.float32)
    return np.meshgrid(x, x)


# -- scenes -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["city_scene", "city_extract_scene"])
def test_city_scenes_match_jax(name):
    js, ts = getattr(JScene, name)(), getattr(Scene, name)(device="cpu")
    arr = jtracer.scene_arrays(js)
    np.testing.assert_array_equal(ts.walls.numpy(), np.asarray(arr.walls))
    np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(arr.kind))
    for ends, jends in ((ts.transmitters, js.transmitters), (ts.receivers, js.receivers)):
        assert list(ends) == list(jends)
        for k in ends:
            np.testing.assert_array_equal(ends[k].numpy(), np.asarray(jends[k].xy))


def test_from_geojson_and_locations_match_jax():
    with open(os.path.join(ROOT, "differt2d_tpu", "data", "city_extract.geojson"), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "data", "city_extract.geojson"), "rb") as f:
        assert f.read() == ref
    for loc in ("N", "E", "S", "W", "C", "NE", "NW", "SE", "SW"):
        js = JScene.from_geojson(ref.decode(), tx_loc=loc, rx_loc="C")
        ts = Scene.from_geojson(ref, tx_loc=loc, rx_loc="C", device="cpu")
        np.testing.assert_array_equal(ts.transmitters["tx"].numpy(),
                                      np.asarray(js.transmitters["tx"].xy))
        np.testing.assert_array_equal(ts.receivers["rx"].numpy(),
                                      np.asarray(js.receivers["rx"].xy))
    empty = Scene.from_geojson('{"features": []}', device="cpu")
    assert empty.num_objects == 0 and empty.transmitters["tx"].tolist() == [0.0, 0.0]
    # An invalid location fails get_location's check, as in the JAX package.
    with pytest.raises(TypeCheckError, match="Expected type: Literal"):
        Scene.city_extract_scene(device="cpu").get_location("X")
    with pytest.raises(NotImplementedError):
        Scene.from_geojson(3, device="cpu")


# -- plain culled against plain unculled ---------------------------------------------


def _random_city(seed, n_buildings=7):
    walls, _, tx = random_city(seed, n_buildings)
    return Scene.from_arrays(walls, transmitters={"tx": tx}, receivers={"rx": [0.5, 0.5]},
                             device="cpu")


def _bitwise_case(case):
    kw = dict(approx=True, sigmoid=False, alpha=100.0)
    scene = _random_city(3)
    if case == "city_extract":
        scene = Scene.city_extract_scene(device="cpu")
    elif case == "city_scene":
        scene = Scene.city_scene(device="cpu")
    elif case == "hard":
        kw["approx"] = False
    elif case == "sigmoid":
        kw.update(sigmoid=True, alpha=3000.0)
    elif case == "ris_vertex":
        scene = scene.add_ris([[0.4, 0.05], [0.6, 0.05]]).add_vertex([0.5, 0.97])
    elif case == "two_tx":
        scene = scene.update_transmitters(tx2=[0.93, 0.08])
    elif case == "tx_grid":
        scene = scene.swap_ends()  # what power_map(on_transmitters=True) hands the wrapper
    return scene, kw


@pytest.mark.parametrize(
    "case", ["city_extract", "city_scene", "hard", "sigmoid", "ris_vertex", "two_tx", "tx_grid"]
)
def test_plain_tables_equal_identity_tables_bitwise(case):
    scene, kw = _bitwise_case(case)
    assert scene.num_objects >= 25
    X, Y = (torch.from_numpy(a) for a in _grid(10, 0.02, 0.98))  # ragged edge tiles
    groups = path_candidate_matrices(scene.num_objects, 0, 1)
    inputs = pml.looped_inputs(groups, "cpu", approx=kw["approx"], sigmoid=kw["sigmoid"])
    txs = torch.stack(list(scene.transmitters.values()))
    scal = (kw["alpha"], 1e-2, 0.0, 0.5, 0.1)
    outs = {}
    for on in (True, False):
        plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs,
                             approx=kw["approx"], sigmoid=kw["sigmoid"], cull=on, shadow=on,
                             tile=(4, 4))
        args = (X.reshape(-1), Y.reshape(-1), scene.walls, scene.kind, scene.phi, scal, inputs,
                plan)
        outs[on] = (pml.plain_looped_value(*args), *pml.plain_looped_value_and_grad(*args))
        if on:
            tb = plan.per_tx[0].tables
            kept = float(tb.cnt[0].sum()) / tb.prm[0].numel()
            listed = float(pml.cull_tables.unpack_words(tb.lastw, scene.num_objects).float().mean())
            assert kept < 0.6 and listed < 0.6, (kept, listed)
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    assert float(outs[True][0].abs().sum()) > 0.0


# -- the slice against the JAX package -------------------------------------------------


@pytest.mark.parametrize("name", ["city_extract_scene", "city_scene"])
def test_city_maps_match_jax(name):
    # On the 0.05-0.95 grid, 6 pixels of city_scene next to the
    # transmitter's street crossing carry near-ties that XLA:CPU's jitted
    # program (FMA contraction) resolves otherwise than its op-by-op run;
    # the port equals the op-by-op run there (test_torch_city_ties.py).
    X, Y = _grid(16, 0.03, 0.97)
    js, ts = getattr(JScene, name)(), getattr(Scene, name)(device="cpu")
    kw = dict(max_order=1, approx=True)
    ok, reason = ttracer._kernel_eligible(ts, kw)
    assert ok and reason.startswith("looped") and "power_map_looped" in reason
    jx, jy = jnp.asarray(X), jnp.asarray(Y)
    tx_, ty_ = torch.from_numpy(X), torch.from_numpy(Y)
    ref = jtracer.power_map(js, jx, jy, backend="xla", **kw)
    got = power_map(ts, tx_, ty_, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(got.sum()) > 0.0
    rv, rg = jtracer.power_map(js, jx, jy, backend="xla", value_and_grad=True, **kw)
    zv, zg = power_map(ts, tx_, ty_, device="cpu", value_and_grad=True, **kw)
    np.testing.assert_allclose(zv.numpy(), np.asarray(rv), **TOL)
    n_bad, allowed = kink_excess(zg, np.asarray(rg), rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed, (n_bad, allowed)


def test_city_autograd_matches_jax_grad():
    """On the first 6 buildings of the city extract (36 walls: the looped
    route).  The Manhattan city_scene and the basic scene carry kink
    pixels on this grid, where one pixel's gradient flips the sum's."""
    X, Y = _grid(8)
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "data", "city_extract.geojson")) as f:
        features = json.load(f)["features"][:6]
    js = JScene.from_geojson(json.dumps({"type": "FeatureCollection", "features": features}))
    walls0 = np.array(jtracer.scene_arrays(js).walls)
    tx0 = np.array(js.transmitters["tx"].xy)

    def jloss(walls, tx):
        s = JScene.from_walls_array(walls).with_transmitters(tx=Point(xy=tx))
        return jtracer.power_map(s, jnp.asarray(X), jnp.asarray(Y), max_order=1, approx=True,
                                 backend="xla").sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(walls0), jnp.asarray(tx0))
    walls = torch.from_numpy(walls0.copy()).requires_grad_(True)
    tx = torch.from_numpy(tx0.copy()).requires_grad_(True)
    ts = Scene.from_arrays(walls, transmitters={"tx": tx}, device="cpu")
    assert ttracer._kernel_eligible(ts, dict(max_order=1))[1].startswith("looped")
    Z = power_map(ts, torch.from_numpy(X), torch.from_numpy(Y), max_order=1, approx=True,
                  device="cpu")
    got = torch.autograd.grad(Z.sum(), (walls, tx))
    for t, j in zip(got, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-3)
    assert float(got[1].abs().sum()) > 0.0


# -- dispatch --------------------------------------------------------------------------


def test_city_requests_route_to_the_looped_kernels(monkeypatch):
    city = Scene.city_extract_scene(device="cpu")
    X, Y = city.grid(5)
    kw = dict(ttracer._OPTIONS, max_order=1, approx=True)
    groups = ttracer._groups_for(city, kw)
    for grad in (False, True):
        assert ttracer._route(city, kw, groups, "auto", grad=grad) == "looped"
        assert ttracer._route(city, kw, groups, "cuda", grad=grad) == "looped"
    calls = []
    real = pml.value

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pml, "value", spy)
    z = power_map(city, X, Y, max_order=1, approx=True, device="cpu")
    assert calls and z.shape == (5, 5)
    # Orders 2 to 4 take the looped kernels too (order 2 of the city extract
    # on a 2 x 2 grid: one tile, every candidate planned); order 5 is
    # beyond their cap (shown on the basic scene: the city extract has 45
    # billion order-5 candidates).
    calls.clear()
    X2, Y2 = city.grid(2)
    z = power_map(city, X2, Y2, max_order=2, approx=True, device="cpu")
    assert calls and z.shape == (2, 2)
    with pytest.raises(NotImplementedError, match="orders <= 4, got 5"):
        power_map(Scene.basic_scene(device="cpu"), X, Y, max_order=5, device="cpu")


def test_looped_gates(monkeypatch):
    city = Scene.city_extract_scene(device="cpu")
    kw = dict(ttracer._OPTIONS, max_order=1, approx=True)
    groups = ttracer._groups_for(city, kw)
    assert ttracer._looped_gates(city, kw, groups) == (True, True)
    assert ttracer._looped_gates(city, dict(kw, approx=False), groups) == (True, True)
    sig = dict(kw, function=sigmoid, alpha=3000.0)
    monkeypatch.setattr(pml, "sigmoid_saturates", lambda device: False)
    assert ttracer._looped_gates(city, sig, groups) == (False, False)
    monkeypatch.setattr(pml, "sigmoid_saturates", lambda device: True)
    assert ttracer._looped_gates(city, sig, groups) == (True, True)
    # A sigmoid band wider than a quarter of the scene prunes nothing.
    assert ttracer._looped_gates(city, dict(sig, alpha=100.0), groups) == (False, False)
    # Vertex-only candidates: nothing to cull, the occluder lists stay.
    vtx = city
    for xy in ([0.2, 0.3], [0.6, 0.45]):
        vtx = vtx.add_vertex(xy)
    only = dict(kw, filter_objects=lambda o: o.kind == 2)
    assert ttracer._looped_gates(vtx, only, ttracer._groups_for(vtx, only)) == (False, True)


def test_sigmoid_saturates_on_the_cpu():
    pml._SIGMOID_SATURATES.pop("cpu", None)
    assert pml.sigmoid_saturates("cpu")


def test_looped_caps_match_the_cuda_source():
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "ops", "csrc", "power_map_looped.cu")) as f:
        src = f.read()
    for name, value in (("LP_MAX_ORDER", pml.MAX_ORDER), ("LP_MAX_WALLS", pml.MAX_WALLS),
                        ("LP_MAX_THREADS", pml.MAX_THREADS)):
        assert f"#define {name} {value}\n" in src, name
    assert pml.TILE[0] * pml.TILE[1] <= pml.MAX_THREADS
    assert "at most" in pml.kernel_caps_reason(pml.MAX_WALLS + 1, 1)
    assert "orders <=" in pml.kernel_caps_reason(7, pml.MAX_ORDER + 1)
    assert pml.kernel_caps_reason(7, pml.MAX_ORDER) is None
    assert pml.kernel_caps_reason(pml.MAX_WALLS, 1) is None
