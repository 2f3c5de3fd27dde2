"""The port's tracer and power maps against the JAX package's XLA tracer.

The reference is ``differt2d_tpu.tracer.power_map(..., backend="xla")``,
the function ``tests/test_pallas.py`` holds the Pallas kernel against.
Grids are built in NumPy float32 and handed to both sides (the 16 x 9 grids
of ``tests/test_pallas.py``, which keep receivers off the walls).  Scenes
are carried across with :func:`load_scene_arrays`.

Value maps match at rtol 1e-4 / atol 1e-5.  Gradient maps are held to the
kink contract (``kink_excess``, PARITY.md), on the second grid of
``tests/test_pallas.py`` (rows 0.07 to 0.93).  On the first one (rows 0.04
to 0.96) three pixels of the basic scene sit where a path segment passes
within a few ulps of the corner (0.4, 0.4) of walls 4 and 5: the two
walls' soft hits tie to a few ulps there, XLA:CPU's fused program (which
contracts ops into FMAs) picks the other wall than its own op-by-op run,
and its gradient differs by up to ~40 at those pixels.  The port agrees
with the op-by-op run there; 3 pixels x 2 components exceed the contract's
floor of 4 elements on a 144-pixel grid.

On the CPU, ``backend="auto"`` runs the kernels' plain versions, so these
tests also cover the kernel route (dispatch, transmitter stacking, path
reversal) up to the launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS, Point, Vertex
from differt2d_tpu.logic import sigmoid as jsigmoid
from differt2d_tpu.rt import path_candidate_matrices as jcands
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import load_scene_arrays, power_map
from differt2d_tpu_torch.logic import sigmoid as tsigmoid
from differt2d_tpu_torch.rt import path_candidate_matrices as tcands
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import kink_excess

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _grid(y0=0.04, y1=0.96):
    x = np.linspace(0.05, 0.95, 16, dtype=np.float32)
    y = np.linspace(y0, y1, 9, dtype=np.float32)
    return np.meshgrid(x, y)


def _port(js: JScene) -> Scene:
    arr = jtracer.scene_arrays(js)
    return load_scene_arrays(
        np.asarray(arr.walls), np.asarray(arr.kind), np.asarray(arr.phi),
        {k: np.asarray(p.xy) for k, p in js.transmitters.items()},
        {k: np.asarray(p.xy) for k, p in js.receivers.items()},
        device="cpu",
    )


def _ris_vertex_scene() -> JScene:
    return JScene.square_scene().add_objects(
        RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]])),
        Vertex(xy=jnp.array([0.25, 0.75])),
    )


def _two_tx_scene() -> JScene:
    return JScene.basic_scene().update_transmitters(tx2=Point(xy=jnp.array([0.8, 0.8])))


def _ref(js, X, Y, **kw):
    return jtracer.power_map(js, jnp.asarray(X), jnp.asarray(Y), backend="xla", **kw)


def _ours(ts, X, Y, **kw):
    return power_map(ts, torch.from_numpy(X), torch.from_numpy(Y), device="cpu", **kw)


def _assert_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _assert_kinks(t, j):
    n_bad, allowed = kink_excess(t, np.asarray(j), rtol=1e-4, atol=1e-5)
    assert n_bad <= allowed, f"{n_bad} gradient elements beyond kink allowance {allowed}"


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("max_order", [0, 1, 2])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_basic_scene_value_maps(backend, max_order, approx):
    js = JScene.basic_scene()
    X, Y = _grid()
    ref = _ref(js, X, Y, max_order=max_order, approx=approx)
    got = _ours(_port(js), X, Y, max_order=max_order, approx=approx, backend=backend)
    assert got.shape == X.shape and got.dtype == torch.float32
    _assert_close(got, ref)


@pytest.mark.parametrize(
    "case",
    ["sigmoid", "runtime_scalars", "ris_vertex", "ris_vertex_order2", "two_tx",
     "on_transmitters", "filter_objects"],
)
def test_value_map_cases(case):
    X, Y = _grid()
    js, kw, tkw = JScene.basic_scene(), dict(max_order=1, approx=True), {}
    if case == "sigmoid":
        kw["function"], tkw["function"] = jsigmoid, tsigmoid
    elif case == "runtime_scalars":
        kw.update(alpha=7.0, tol=0.05, patch=0.1, r_coef=0.8, height=0.25)
    elif case == "ris_vertex":
        js = _ris_vertex_scene()
        X, Y = _grid(0.07, 0.93)
    elif case == "ris_vertex_order2":
        js = _ris_vertex_scene()
        X, Y = _grid(0.07, 0.93)
        kw["max_order"] = 2
    elif case == "two_tx":
        js = _two_tx_scene()
    elif case == "on_transmitters":
        kw["on_transmitters"] = True
    elif case == "filter_objects":
        js = JScene.square_scene().add_objects(RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]])))
        kw = dict(order=1, approx=True, filter_objects=lambda o: isinstance(o, RIS))
        tkw["filter_objects"] = lambda o: o.kind == 1
    ref = _ref(js, X, Y, **kw)
    ts = _port(js)
    for backend in ("auto", "torch"):
        got = _ours(ts, X, Y, backend=backend, **{**kw, **tkw})
        _assert_close(got, ref)


@pytest.mark.parametrize(
    "case", ["hard", "soft", "sigmoid", "order2", "ris_vertex", "two_tx", "on_transmitters"]
)
def test_gradient_maps(case):
    X, Y = _grid(0.07, 0.93)
    js, kw, tkw = JScene.basic_scene(), dict(max_order=1, approx=True), {}
    if case == "hard":
        kw["approx"] = False
    elif case == "sigmoid":
        kw["function"], tkw["function"] = jsigmoid, tsigmoid
    elif case == "order2":
        kw["max_order"] = 2
        tkw["backend"] = "torch"  # the JAX package sends it to its looped kernel
    elif case == "ris_vertex":
        js = _ris_vertex_scene()
    elif case == "two_tx":
        js = _two_tx_scene()
    elif case == "on_transmitters":
        kw["on_transmitters"] = True
    rv, rg = _ref(js, X, Y, value_and_grad=True, **kw)
    assert np.isfinite(np.asarray(rg)).all()
    ts = _port(js)
    zv, zg = _ours(ts, X, Y, value_and_grad=True, **{**kw, **tkw})
    assert zg.shape == (*X.shape, 2)
    _assert_close(zv, rv)
    _assert_kinks(zg, rg)
    g = _ours(ts, X, Y, grad=True, **{**kw, **tkw})
    np.testing.assert_array_equal(g.numpy(), zg.numpy())


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_path_candidate_matrices_equal(order, filtered):
    flt = (1, 4) if filtered else None
    for n in (3, 7):
        ref = jcands(n, order=order, filter_nodes=flt)
        got = tcands(n, order=order, filter_nodes=flt)
        assert set(ref) == set(got)
        for o in ref:
            np.testing.assert_array_equal(got[o], np.asarray(ref[o]))
            assert got[o].dtype == np.int32


def test_scene_factories_match():
    for jf, tf in ((JScene.basic_scene, Scene.basic_scene),
                   (JScene.square_scene, Scene.square_scene)):
        js, ts = jf(), tf(device="cpu")
        arr = jtracer.scene_arrays(js)
        np.testing.assert_array_equal(ts.walls.numpy(), np.asarray(arr.walls))
        np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(arr.kind))
        for k in js.transmitters:
            np.testing.assert_array_equal(ts.transmitters[k].numpy(), np.asarray(js.transmitters[k].xy))
        jX, jY = js.grid(5)
        tX, tY = ts.grid(5)
        np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-6)
        np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=1e-6)
    mixed = Scene.square_scene(device="cpu").add_ris([[0.5, 0.3], [0.5, 0.7]]).add_vertex([0.25, 0.75])
    ref = _port(_ris_vertex_scene())
    np.testing.assert_allclose(mixed.walls.numpy(), ref.walls.numpy())
    np.testing.assert_allclose(mixed.phi.numpy(), ref.phi.numpy())
    assert mixed.kinds == ref.kinds == (0, 0, 0, 0, 1, 2)


def test_autograd_through_value_map_matches_jax():
    """Gradients of the map's sum w.r.t. TX, walls and alpha (the kernel
    route's backward) against jax.grad of the XLA tracer, on a grid clear
    of the corner near-ties."""
    X, Y = _grid(0.07, 0.93)
    js = JScene.basic_scene()
    arr = jtracer.scene_arrays(js)
    walls0 = np.asarray(arr.walls)
    tx0 = np.asarray(js.transmitters["tx"].xy)

    def jloss(walls, tx, alpha):
        s = JScene.from_walls_array(walls).with_transmitters(tx=Point(xy=tx))
        return jtracer.power_map(s, jnp.asarray(X), jnp.asarray(Y), max_order=1,
                                 approx=True, alpha=alpha, backend="xla").sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(walls0), jnp.asarray(tx0), 100.0)
    walls = torch.from_numpy(walls0.copy()).requires_grad_(True)
    tx = torch.from_numpy(tx0.copy()).requires_grad_(True)
    alpha = torch.tensor(100.0, requires_grad=True)
    ts = Scene.from_arrays(walls, transmitters={"tx": tx}, device="cpu")
    for backend in ("auto", "torch"):
        Z = _ours(ts, X, Y, max_order=1, approx=True, alpha=alpha, backend=backend)
        got = torch.autograd.grad(Z.sum(), (walls, tx, alpha))
        for t, j in zip(got, jg):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-3)
