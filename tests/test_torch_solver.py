"""The port's Fermat/MPT solver against the JAX package.

The optimizer (``optimize.minimize``), the eager solve and the solver
kernel's route (on the CPU, its plain version) are held against
``differt2d_tpu``: ``optimize.minimize`` and ``tracer.power_map(...,
backend="xla")`` with the same key, on the 16 x 9 grid of
``tests/test_pallas.py`` (50 adam steps).  Tolerances: Fermat maps rtol 1e-3
/ atol 1e-4 and RIS MPT maps rtol 1e-3 / atol 1e-5 (``tests/test_pallas.py``),
MPT maps on walls under the flip contract of PARITY.md (at most 0.5% of the
pixels beyond 0.05 (1 + |ref|), the others within 1e-3 relative).  The JAX
references are computed once per module.  Gradients through the solver are
``tests/test_torch_solver_grad.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt2d_tpu import optimize as joptimize
from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS
from differt2d_tpu.logic import sigmoid as jsigmoid
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import eager, load_scene_arrays, optimize, power_map, prng
from differt2d_tpu_torch.logic import sigmoid as tsigmoid
from differt2d_tpu_torch.scene import Scene

torch.set_num_threads(1)

SEED = 1234
STEPS = 50
FERMAT_TOL = dict(rtol=1e-3, atol=1e-4)
RIS_TOL = dict(rtol=1e-3, atol=1e-5)


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


# name: (scene, JAX options, port options besides them, contract)
CASES = {
    "fermat_walls": ("square", dict(order=1, solver="fermat"), {}, "fermat"),
    "mpt_walls": ("square", dict(order=1, solver="mpt"), {}, "flip"),
    "mpt_ris": ("ris", dict(order=1, solver="mpt", filter_objects=lambda o: isinstance(o, RIS)),
                dict(filter_objects=lambda o: o.kind == 1), "ris"),
    "fermat_orders_0_1": ("square", dict(min_order=0, max_order=1, solver="fermat"), {}, "fermat"),
    "mpt_many_3": ("square", dict(order=1, solver="mpt", many=3), {}, "flip"),
    "fermat_on_transmitters": ("square", dict(order=1, solver="fermat", on_transmitters=True), {},
                               "fermat"),
    "mpt_sigmoid": ("square", dict(order=1, solver="mpt", function=jsigmoid),
                    dict(function=tsigmoid), "flip"),
}


def _jscene(name: str) -> JScene:
    return {"square": JScene.square_scene, "ris": _ris_scene}[name]()


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> np.ndarray:
    name, jkw, _, _ = CASES[case]
    X, Y = _grid()
    return np.asarray(jtracer.power_map(
        _jscene(name), jnp.asarray(X), jnp.asarray(Y), backend="xla", approx=True,
        steps=STEPS, key=jax.random.PRNGKey(SEED), **jkw,
    ))


def _assert_contract(got, ref, contract: str):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    if contract == "fermat":
        np.testing.assert_allclose(got, ref, **FERMAT_TOL)
    elif contract == "ris":
        np.testing.assert_allclose(got, ref, **RIS_TOL)
    else:
        err = np.abs(got - ref)
        scale = 1.0 + np.abs(ref)
        flipped = err > 0.05 * scale
        assert flipped.mean() <= 0.005, flipped.mean()
        rest = (err[~flipped] / scale[~flipped]).max() if (~flipped).any() else 0.0
        assert rest <= 1e-3, rest


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_maps_match_jax(case, backend):
    name, jkw, tkw, contract = CASES[case]
    X, Y = _grid()
    got = power_map(_port(_jscene(name)), torch.from_numpy(X), torch.from_numpy(Y),
                    device="cpu", backend=backend, approx=True, steps=STEPS,
                    key=prng.PRNGKey(SEED), **{**jkw, **tkw})
    assert got.shape == X.shape and got.dtype == torch.float32
    assert float(got.sum()) > 0.0
    _assert_contract(got, _reference(case), contract)


@pytest.mark.parametrize("objective", ["quadratic", "mpt_candidate"])
def test_minimize_matches_jax(objective):
    """``optimize.minimize`` against ``differt2d_tpu.optimize.minimize`` (optax
    adam in a scan): a fixed quadratic, and one candidate's MPT objective
    (a specular bounce on a wall of ``square_scene``)."""
    rng = np.random.default_rng(0)
    if objective == "quadratic":
        c = rng.normal(size=5).astype(np.float32)
        w = rng.uniform(0.5, 3.0, 5).astype(np.float32)
        x0 = rng.uniform(0, 1, 5).astype(np.float32)
        jfun = lambda x: jnp.sum(w * (x - c) ** 2)  # noqa: E731
        tfun = lambda x: torch.sum(torch.from_numpy(w) * (x - torch.from_numpy(c)) ** 2)  # noqa: E731
        steps = 200
    else:
        arr = jtracer.scene_arrays(JScene.square_scene())
        wall = np.array(arr.walls)[1:2]
        tx, rx = np.float32([0.1, 0.1]), np.float32([0.3, 0.8])
        x0 = prng.uniform(prng.PRNGKey(SEED), (1,))

        def jfun(theta):
            pts = jtracer._theta_to_points(theta, jnp.asarray(wall), jnp.zeros(1, jnp.int32))
            full = jnp.concatenate([tx[None], pts, rx[None]])
            return jtracer._bounce_residuals(full[None], jnp.asarray(wall)[None],
                                             jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)))[0]

        def tfun(theta):
            pts = eager._theta_to_points(theta[None], torch.from_numpy(wall)[None],
                                         torch.zeros(1, 1, dtype=torch.int64))
            full = torch.cat([torch.from_numpy(tx)[None, None], pts,
                              torch.from_numpy(rx)[None, None]], dim=1)[None]
            return eager._bounce_residuals(full, torch.from_numpy(wall)[None],
                                           torch.zeros(1, 1, dtype=torch.int64),
                                           torch.zeros(1, 1))[0, 0]

        steps = STEPS
    jx, jloss = joptimize.minimize(jfun, jnp.asarray(x0), steps=steps)
    tx_, tloss = optimize.minimize(tfun, torch.from_numpy(x0.copy()), steps=steps)
    np.testing.assert_allclose(tx_.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, atol=1e-6)


def test_group_keys_follow_the_jax_enumeration():
    """One key per candidate from ``split(key, total)`` in order-major
    enumeration, and the draws ``tracer.py:269-278`` makes from them."""
    groups = {0: np.zeros((1, 0), np.int32), 1: np.arange(4, dtype=np.int32)[:, None]}
    keys = eager.group_keys(groups, prng.PRNGKey(SEED))
    jkeys = np.asarray(jax.random.split(jax.random.PRNGKey(SEED), 5))
    np.testing.assert_array_equal(keys[0], jkeys[:1])
    np.testing.assert_array_equal(keys[1], jkeys[1:])
    x0 = eager.solver_inits(keys[1], 1, 3)
    ref = jax.vmap(lambda k: jax.vmap(lambda s: jax.random.uniform(s, (1,)))(
        jax.random.split(k, 3)))(jnp.asarray(jkeys[1:]))
    np.testing.assert_array_equal(x0, np.asarray(ref))
    np.testing.assert_array_equal(eager.solver_inits(keys[1], 1, 1)[:, 0],
                                  np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1,)))(
                                      jnp.asarray(jkeys[1:]))))


def test_unported_gradient_modes_raise():
    """The three gradient modes that raised before they were ported now
    run and match the JAX package: the optimizer's at rtol 1e-5 / atol
    1e-6, the implicit map at Fermat's rtol 1e-3 / atol 1e-4 with a finite
    pixel gradient (held against JAX's in ``test_torch_grad_modes.py``).
    The name is kept from when they raised."""
    p0 = np.array([0.7, -0.3], np.float32)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    x, _ = optimize.minimize(lambda x, p: ((x - p) ** 2).sum(), torch.zeros(2), args=(p,),
                             implicit=True)
    (g,) = torch.autograd.grad(x.sum(), p)
    jg = jax.grad(lambda q: joptimize.minimize(lambda x, q: jnp.sum((x - q) ** 2), jnp.zeros(2),
                                               args=(q,), implicit=True)[0].sum())(jnp.asarray(p0))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    v, g = optimize.value_and_grad_fwd(lambda x: (x * x).sum())(torch.from_numpy(p0.copy()))
    jv, jg = joptimize.value_and_grad_fwd(lambda x: jnp.sum(x * x))(jnp.asarray(p0))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    scene = Scene.square_scene(device="cpu")
    X, Y = scene.grid(4)
    kw = dict(order=1, solver="fermat", steps=STEPS, approx=True)
    z, dz = power_map(scene, X, Y, solver_grad="implicit", value_and_grad=True,
                      key=prng.PRNGKey(SEED), device="cpu", **kw)
    jz = jtracer.power_map(JScene.square_scene(), jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()),
                           solver_grad="implicit", key=jax.random.PRNGKey(SEED), backend="xla",
                           **kw)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **FERMAT_TOL)
    assert bool(torch.isfinite(dz).all()) and float(dz.abs().max()) > 0
