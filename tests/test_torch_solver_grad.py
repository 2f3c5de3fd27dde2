"""Gradients through the port's Fermat/MPT solver against the JAX package.

The unrolled adam solve is differentiated by autograd: a Fermat gradient
map (the eager route) under the kink contract, and the gradients of an RIS
map's sum with respect to the RIS phase and the transmitter through the
solver kernel's route (``SolverMapFunction``: the kernel's forward, on the
CPU its plain version, and the eager solve's backward) against ``jax.grad``
of ``differt2d_tpu.tracer.power_map(..., backend="xla")``, on the 16 x 9 grid
of ``tests/test_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS, Point
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import load_scene_arrays, power_map, prng
from differt2d_tpu_torch.ops import opt_solver_kernel as osk
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import kink_excess

torch.set_num_threads(1)

SEED = 1234
STEPS = 50
FERMAT_TOL = dict(rtol=1e-3, atol=1e-4)


def _grid(y0=0.04, y1=0.96):
    x = np.linspace(0.05, 0.95, 16, dtype=np.float32)
    y = np.linspace(y0, y1, 9, dtype=np.float32)
    return np.meshgrid(x, y)


def _ris_scene(phi=np.pi / 4) -> JScene:
    return JScene.square_scene().add_objects(
        RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]]), phi=jnp.asarray(phi, jnp.float32))
    )


def _port(js: JScene) -> Scene:
    arr = jtracer.scene_arrays(js)
    return load_scene_arrays(
        np.asarray(arr.walls), np.asarray(arr.kind), np.asarray(arr.phi),
        {k: np.asarray(p.xy) for k, p in js.transmitters.items()},
        {k: np.asarray(p.xy) for k, p in js.receivers.items()},
        device="cpu",
    )


def test_fermat_gradient_map_matches_jax():
    X, Y = _grid(0.07, 0.93)
    kw = dict(order=1, solver="fermat", steps=STEPS, approx=True)
    rv, rg = jtracer.power_map(JScene.square_scene(), jnp.asarray(X), jnp.asarray(Y),
                               backend="xla", value_and_grad=True,
                               key=jax.random.PRNGKey(SEED), **kw)
    ts = _port(JScene.square_scene())
    zv, zg = power_map(ts, torch.from_numpy(X), torch.from_numpy(Y), device="cpu",
                       value_and_grad=True, key=prng.PRNGKey(SEED), **kw)
    np.testing.assert_allclose(zv.numpy(), np.asarray(rv), **FERMAT_TOL)
    n_bad, allowed = kink_excess(zg, np.asarray(rg), **FERMAT_TOL)
    assert n_bad <= allowed, f"{n_bad} gradient elements beyond kink allowance {allowed}"
    g = power_map(ts, torch.from_numpy(X), torch.from_numpy(Y), device="cpu", grad=True,
                  key=prng.PRNGKey(SEED), **kw)
    np.testing.assert_array_equal(g.numpy(), zg.numpy())


def test_autograd_through_the_solver_route_matches_jax():
    """Gradients of an RIS map's sum w.r.t. the phase and the transmitter:
    the solver route (kernel forward, eager backward) and the eager route
    against jax.grad of the XLA tracer."""
    X, Y = _grid()
    flt = lambda o: isinstance(o, RIS)  # noqa: E731
    kw = dict(order=1, solver="mpt", steps=20, approx=True)
    tx0 = np.asarray(JScene.square_scene().transmitters["tx"].xy)

    def jloss(phi, tx):
        s = _ris_scene(phi).with_transmitters(tx=Point(xy=tx))
        return jtracer.power_map(s, jnp.asarray(X), jnp.asarray(Y), backend="xla",
                                 key=jax.random.PRNGKey(SEED), filter_objects=flt, **kw).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.float32(np.pi / 4), jnp.asarray(tx0))
    base = _port(_ris_scene())
    for backend in ("auto", "torch"):
        phi = base.phi.clone().requires_grad_(True)
        tx = torch.from_numpy(tx0.copy()).requires_grad_(True)
        sc = Scene.from_arrays(base.walls, base.kind, phi, {"tx": tx}, device="cpu")
        Z = power_map(sc, torch.from_numpy(X), torch.from_numpy(Y), device="cpu",
                      backend=backend, key=prng.PRNGKey(SEED),
                      filter_objects=lambda o: o.kind == 1, **kw)
        gphi, gtx = torch.autograd.grad(Z.sum(), (phi, tx))
        np.testing.assert_allclose(gphi[-1].numpy(), np.asarray(jg[0]), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(gtx.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-3)


def test_solver_function_backward_with_injected_forward(monkeypatch):
    """SolverMapFunction on the CPU, with the plain forward injected in place
    of the launch: the eager route's gradients."""
    calls = []

    def injected(*args, approx, sigmoid):
        calls.append(1)
        return osk.plain_opt_value(*args)

    monkeypatch.setattr(osk, "value", injected)
    X, Y = _grid()
    base = _port(JScene.square_scene())
    kw = dict(min_order=0, max_order=1, solver="fermat", steps=20, approx=True,
              key=prng.PRNGKey(SEED))

    def grads(backend):
        walls = base.walls.clone().requires_grad_(True)
        tx = base.transmitters["tx"].clone().requires_grad_(True)
        alpha = torch.tensor(100.0, requires_grad=True)
        sc = Scene.from_arrays(walls, base.kind, base.phi, {"tx": tx}, device="cpu")
        Z = power_map(sc, torch.from_numpy(X), torch.from_numpy(Y), alpha=alpha,
                      backend=backend, device="cpu", **kw)
        return (Z, *torch.autograd.grad((Z * Z).sum(), (walls, tx, alpha)))

    got = grads("auto")
    assert calls, "the injected forward did not run"
    for g, r in zip(got, grads("torch")):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
