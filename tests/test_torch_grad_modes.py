"""The port's gradient modes against the JAX package's.

``optimize.minimize(implicit=True)`` (implicit-function derivatives),
``optimize.value_and_grad_fwd`` (forward mode) and the restarts of
``minimize_many_random_uniform`` are held against ``differt2d_tpu.optimize``;
the bench's two optimisation losses against the same losses in the JAX
package: cfg3, the transmitter step of ``bench.py:628-700`` (MPT paths on
``square_scene_with_wall`` through ``accumulate_over_paths``, 100 steps,
alpha 50) in its three modes, and cfg5, the RIS phase step of
``bench.py:896-928`` (an order-1 MPT map on an 8 x 8 grid, which the port
sends to the solver kernel's ``SolverMapFunction``, its plain forward
standing in for the kernel on the CPU) in both modes.  Forward mode is the
derivative of the unrolled solve, so the port's forward gradients are held
against ``jax.value_and_grad`` of the unrolled loss (which JAX's own tests
hold equal to its ``value_and_grad_fwd`` at rtol 1e-5).

Tolerances: the optimizer's unit problems rtol 1e-5 / atol 1e-6
(``tests/test_optimize.py``'s); losses rtol 1e-4 and their gradients rtol
1e-3 / atol 1e-5; forward against reverse within the port rtol 1e-5 /
atol 1e-6; implicit against unrolled rtol 5e-2 / atol 1e-3 (JAX's).
Inputs come from one seed; the JAX references are computed once per
module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from differt2d_tpu import optimize as joptimize
from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS as JRIS
from differt2d_tpu.geometry import MinPath as JMinPath
from differt2d_tpu.geometry import Point as JPoint
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu.utils import received_power as jreceived_power
from differt2d_tpu_torch import optimize, power_map, prng
from differt2d_tpu_torch.geometry import RIS, MinPath, Point
from differt2d_tpu_torch.ops import opt_solver_kernel as osk
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.ops import power_map_looped as pml
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import kink_excess, received_power

torch.set_num_threads(1)

SEED = 1234
UNIT_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=0.0)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
FWD_REV_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jq(x, p):
    return jnp.sum((x - p) ** 2 + 0.1 * (x - p) ** 4)


def _tq(x, p):
    return torch.sum((x - p) ** 2 + 0.1 * (x - p) ** 4)


def test_implicit_minimize_matches_jax_on_the_quartic():
    """Same forward solve as the unrolled one (bit for bit); gradients of
    ``x*`` and of the loss (its envelope term) equal JAX's implicit ones,
    hit the analytic ``dx*/dp = I`` and stay near the unrolled ones; ``x0``
    gets no gradient."""
    p0 = np.array([0.7, -0.3], np.float32)  # tests/test_optimize.py's point
    w = np.array([2.0, 3.0], np.float32)

    def touter(p, x0, implicit):
        x, loss = optimize.minimize(_tq, x0, args=(p,), steps=100, implicit=implicit)
        return torch.sum(x * torch.from_numpy(w)) + 0.5 * loss

    def jouter(p, implicit):
        x, loss = joptimize.minimize(_jq, jnp.zeros(2), args=(p,), steps=100, implicit=implicit)
        return jnp.sum(x * jnp.asarray(w)) + 0.5 * loss

    pi = torch.from_numpy(p0.copy())
    xu, lu = optimize.minimize(_tq, torch.zeros(2), args=(pi,), steps=100)
    xi, li = optimize.minimize(_tq, torch.zeros(2), args=(pi,), steps=100, implicit=True)
    assert torch.equal(xu, xi) and torch.equal(lu, li)
    grads = {}
    for implicit in (True, False):
        p = torch.from_numpy(p0.copy()).requires_grad_(True)
        x0 = torch.zeros(2, requires_grad=True)
        grads[implicit] = torch.autograd.grad(touter(p, x0, implicit), (p, x0),
                                              allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(_np(grads[True][0]), np.asarray(jax.grad(jouter)(jnp.asarray(p0), True)),
                               **UNIT_TOL)
    np.testing.assert_allclose(_np(grads[True][0]), w, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(_np(grads[True][0]), _np(grads[False][0]), rtol=5e-2, atol=1e-3)
    assert float(grads[True][1].abs().max()) == 0.0


def test_implicit_jvp_matches_its_vjp_and_jax():
    """The Function's ``jvp`` (torch.func.jvp) and ``backward`` are one
    rule: forward and reverse gradients agree (JAX's own test), and equal
    JAX's forward-mode tangents."""
    p0 = np.array([0.4, 0.9], np.float32)

    def touter(p):
        x, _ = optimize.minimize(_tq, torch.zeros(2), args=(p,), steps=50, implicit=True)
        return torch.sum(x**2)

    def jouter(p):
        x, _ = joptimize.minimize(_jq, jnp.zeros(2), args=(p,), steps=50, implicit=True)
        return jnp.sum(x**2)

    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    (g_rev,) = torch.autograd.grad(touter(p), p)
    g_fwd = torch.stack([optimize.jvp(touter, (torch.from_numpy(p0.copy()),), (t,))[1]
                         for t in torch.eye(2)])
    np.testing.assert_allclose(_np(g_fwd), _np(g_rev), **FWD_REV_TOL)
    j_fwd = np.stack([np.asarray(jax.jvp(jouter, (jnp.asarray(p0),), (jnp.asarray(t),))[1])
                      for t in np.eye(2, dtype=np.float32)])
    np.testing.assert_allclose(_np(g_fwd), j_fwd, **UNIT_TOL)


def test_implicit_blocks_are_per_objective():
    """A batch of independent objectives (the eager solve's form) gets one
    Hessian block each: its gradients equal those of separate solves, and
    ``vmap`` over the implicit solve (its generated rule) gives them too."""
    rng = np.random.default_rng(SEED + 1)
    P = rng.uniform(-1, 1, size=(3, 2)).astype(np.float32)
    batched = torch.from_numpy(P.copy()).requires_grad_(True)
    x, loss = optimize.minimize(lambda x, p: torch.sum((x - p) ** 2 + 0.1 * (x - p) ** 4, dim=-1),
                                torch.zeros(3, 2), args=(batched,), steps=60, implicit=True)
    (g_batched,) = torch.autograd.grad((x**3).sum() + loss.sum(), batched)
    for i in range(3):
        p = torch.from_numpy(P[i].copy()).requires_grad_(True)
        xi, li = optimize.minimize(_tq, torch.zeros(2), args=(p,), steps=60, implicit=True)
        (gi,) = torch.autograd.grad((xi**3).sum() + li, p)
        np.testing.assert_allclose(_np(g_batched[i]), _np(gi), **UNIT_TOL)

    def one(p):
        xi, li = optimize.minimize(_tq, torch.zeros(2), args=(p,), steps=60, implicit=True)
        return (xi**3).sum() + li

    g_vmap = torch.func.vmap(torch.func.grad(one))(torch.from_numpy(P.copy()))
    np.testing.assert_allclose(_np(g_vmap), _np(g_batched), **UNIT_TOL)


_FWD_CASES = {
    "quadratic": (lambda x: torch.sum((x - 2.0) ** 2 * torch.tensor([1.0, 3.0])),
                  lambda x: jnp.sum((x - 2.0) ** 2 * jnp.array([1.0, 3.0])),
                  np.array([0.5, -1.5], np.float32)),
    "scalar": (lambda p: torch.sin(p) * 3.0, lambda p: jnp.sin(p) * 3.0,
               np.array(0.3, np.float32)),
    "through the unrolled solve": (
        lambda p: optimize.minimize(_tq, torch.zeros(2), args=(p,), steps=40)[0].pow(2).sum(),
        lambda p: jnp.sum(joptimize.minimize(_jq, jnp.zeros(2), args=(p,), steps=40)[0] ** 2),
        np.array([0.4, -0.7], np.float32)),
}


@pytest.mark.parametrize("case", sorted(_FWD_CASES))
def test_value_and_grad_fwd_matches_jax(case):
    tfun, jfun, x0 = _FWD_CASES[case]
    v, g = optimize.value_and_grad_fwd(tfun)(torch.from_numpy(x0.copy()))
    jv, jg = joptimize.value_and_grad_fwd(jfun)(jnp.asarray(x0))
    assert g.shape == x0.shape
    np.testing.assert_allclose(_np(v), np.asarray(jv), **UNIT_TOL)
    np.testing.assert_allclose(_np(g), np.asarray(jg), **UNIT_TOL)
    x = torch.from_numpy(x0.copy()).requires_grad_(True)
    (g_rev,) = torch.autograd.grad(tfun(x), x)
    np.testing.assert_allclose(_np(g), _np(g_rev), **FWD_REV_TOL)


def test_minimize_random_uniform_and_restarts_match_jax():
    """``x0`` is JAX's draw bit for bit; ``many`` restarts split the key and
    keep the least final loss; ``many == 1`` draws from the key itself."""
    fun_t = lambda x: torch.sum((x - 0.3) ** 2 + torch.sin(5.0 * x))  # noqa: E731
    fun_j = lambda x: jnp.sum((x - 0.3) ** 2 + jnp.sin(5.0 * x))  # noqa: E731
    for many in (1, 4):
        tx, tl = optimize.minimize_many_random_uniform(fun_t, prng.PRNGKey(SEED), 3, many=many,
                                                       steps=30, device="cpu")
        jx, jl = joptimize.minimize_many_random_uniform(fun_j, jax.random.PRNGKey(SEED), 3,
                                                        many=many, steps=30)
        np.testing.assert_allclose(_np(tx), np.asarray(jx), **UNIT_TOL)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **UNIT_TOL)
    one = optimize.minimize_random_uniform(fun_t, prng.PRNGKey(SEED), 3, steps=30, device="cpu")
    many1 = optimize.minimize_many_random_uniform(fun_t, prng.PRNGKey(SEED), 3, many=1, steps=30,
                                                  device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(one, many1))
    x0 = optimize.minimize(fun_t, torch.from_numpy(prng.uniform(prng.PRNGKey(SEED), (3,))),
                           steps=30)
    assert all(torch.equal(a, b) for a, b in zip(one, x0))


# -- cfg3: the transmitter step (bench.py:628-700) ------------------------------

_TX0 = np.array([0.3, 0.6], np.float32)


def _cfg3_jax_loss(tx, implicit=False):
    s = JScene.square_scene_with_wall().with_transmitters(tx=JPoint(xy=tx))
    return -s.accumulate_over_paths(
        jreceived_power, reduce_all=True, max_order=1, approx=True, alpha=50.0,
        path_cls=JMinPath, path_cls_kwargs={"steps": 100, **({"implicit": True} if implicit else {})},
        key=jax.random.PRNGKey(SEED),
    )


def _cfg3_loss(tx, implicit=False):
    s = Scene.square_scene_with_wall(device="cpu").with_transmitters(tx=Point(xy=tx))
    return -s.accumulate_over_paths(
        received_power, reduce_all=True, max_order=1, approx=True, alpha=50.0,
        path_cls=MinPath, path_cls_kwargs={"steps": 100, **({"implicit": True} if implicit else {})},
        key=prng.PRNGKey(SEED),
    )


@functools.lru_cache(maxsize=None)
def _cfg3_jax(implicit: bool):
    v, g = jax.value_and_grad(_cfg3_jax_loss)(jnp.asarray(_TX0), implicit)
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("mode", ["unroll", "implicit", "forward"])
def test_cfg3_tx_step_matches_jax(mode):
    if mode == "forward":
        v, g = optimize.value_and_grad_fwd(_cfg3_loss)(torch.from_numpy(_TX0.copy()))
    else:
        tx = torch.from_numpy(_TX0.copy()).requires_grad_(True)
        v = _cfg3_loss(tx, mode == "implicit")
        (g,) = torch.autograd.grad(v, tx)
    jv, jg = _cfg3_jax(mode == "implicit")
    np.testing.assert_allclose(_np(v), jv, **LOSS_TOL)
    np.testing.assert_allclose(_np(g), jg, **GRAD_TOL)
    assert float(np.abs(jg).max()) > 1e-2


# -- cfg5: the RIS phase step (bench.py:896-928) --------------------------------

_RIS_XYS = np.array([[0.5, 0.3], [0.5, 0.7]], np.float32)
_PHI0 = np.float32(0.5)


def _ris_grid():
    return np.meshgrid(np.linspace(0.05, 0.45, 8, dtype=np.float32),
                       np.linspace(0.05, 0.95, 8, dtype=np.float32))


def _cfg5_loss(phi):
    s = Scene.square_scene(device="cpu").add_objects(RIS(xys=torch.from_numpy(_RIS_XYS), phi=phi))
    X, Y = (torch.from_numpy(a) for a in _ris_grid())
    Z = power_map(s, X, Y, order=1, solver="mpt", steps=100, approx=True, key=prng.PRNGKey(SEED),
                  filter_objects=lambda o: isinstance(o, RIS), device="cpu")
    return -torch.sum(Z)


@functools.lru_cache(maxsize=None)
def _cfg5_jax():
    X, Y = (jnp.asarray(a) for a in _ris_grid())

    def loss(phi):
        s = JScene.square_scene().add_objects(JRIS(xys=jnp.asarray(_RIS_XYS), phi=phi))
        Z = jtracer.power_map(s, X, Y, order=1, solver="mpt", steps=100, approx=True,
                              key=jax.random.PRNGKey(SEED),
                              filter_objects=lambda o: isinstance(o, JRIS))
        return -jnp.sum(Z)

    v, g = jax.value_and_grad(loss)(jnp.asarray(_PHI0))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
def test_cfg5_ris_step_matches_jax_through_the_solver_function(mode, monkeypatch):
    calls = []
    for name in ("jvp", "backward"):
        real = getattr(osk.SolverMapFunction, name)

        def spy(ctx, *a, real=real, name=name):
            calls.append(name)
            return real(ctx, *a)

        monkeypatch.setattr(osk.SolverMapFunction, name, staticmethod(spy))
    if mode == "forward":
        v, g = optimize.value_and_grad_fwd(_cfg5_loss)(torch.tensor(_PHI0))
    else:
        phi = torch.tensor(_PHI0, requires_grad=True)
        v = _cfg5_loss(phi)
        (g,) = torch.autograd.grad(v, phi)
    assert calls == ["jvp" if mode == "forward" else "backward"]
    jv, jg = _cfg5_jax()
    np.testing.assert_allclose(_np(v), jv, **LOSS_TOL)
    np.testing.assert_allclose(_np(g), jg, **GRAD_TOL)
    assert float(np.abs(jg)) > 1e-2


@functools.lru_cache(maxsize=None)
def _implicit_jax_map():
    js = JScene.square_scene()
    X, Y = jnp.meshgrid(jnp.linspace(0.1, 0.9, 6), jnp.linspace(0.1, 0.9, 6))
    out = jtracer.power_map(js, X, Y, value_and_grad=True, solver_grad="implicit", order=1,
                            solver="mpt", steps=100, approx=True, key=jax.random.PRNGKey(SEED),
                            backend="xla")
    return np.array(X), np.array(Y), *(np.asarray(o) for o in out)


def test_power_map_implicit_solver_grad_matches_jax():
    """``solver_grad="implicit"``: the map is the unrolled one's bit for
    bit, and the pixel gradients are JAX's implicit ones (values rtol 1e-4
    / atol 1e-5, gradients under the kink contract at rtol 1e-3 / atol
    1e-5)."""
    Xn, Yn, jZ, jdZ = _implicit_jax_map()
    scene = Scene.square_scene(device="cpu")
    kw = dict(order=1, solver="mpt", steps=100, approx=True, key=prng.PRNGKey(SEED), device="cpu")
    X, Y = torch.from_numpy(Xn), torch.from_numpy(Yn)
    Z, dZ = power_map(scene, X, Y, value_and_grad=True, solver_grad="implicit", **kw)
    Zu = power_map(scene, X, Y, **kw)
    assert torch.equal(Z, Zu)
    np.testing.assert_allclose(_np(Z), jZ, rtol=1e-4, atol=1e-5)
    n_bad, allowed = kink_excess(dZ, jdZ, rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed
    assert float(np.abs(jdZ).max()) > 1.0


def _map_jvp(route: str, backend: str):
    """``(map, tangent)`` of a map through one kernel family's Function on
    the CPU (``backend="auto"``, the kernel's plain forward standing in) or
    through the eager tracer (``backend="torch"``), along one scene
    tensor."""
    if route == "unrolled":
        scene, kw = Scene.basic_scene(device="cpu"), dict(max_order=1, approx=True)
        primal, tangent = scene.transmitters["tx"], torch.tensor([0.3, -1.0])

        def build(tx):
            return scene.update_transmitters(tx=tx)
    elif route == "looped":
        scene, kw = Scene.city_scene(blocks=(3, 3), device="cpu"), dict(max_order=1, approx=True)
        primal, tangent = scene.walls, torch.linspace(-1, 1, scene.walls.numel()).reshape(
            scene.walls.shape)

        def build(walls):
            return scene.replace(walls=walls)
    else:
        scene = Scene.square_scene(device="cpu").add_ris(_RIS_XYS)
        kw = dict(order=1, solver="mpt", steps=40, approx=True, key=prng.PRNGKey(SEED),
                  filter_objects=lambda o: o.kind == 1)
        primal, tangent = scene.phi, torch.ones_like(scene.phi)

        def build(phi):
            return scene.replace(phi=phi)
    X, Y = (torch.from_numpy(a) for a in np.meshgrid(np.linspace(0.07, 0.93, 4, dtype=np.float32),
                                                     np.linspace(0.11, 0.89, 3, dtype=np.float32)))
    return optimize.jvp(lambda p: power_map(build(p), X, Y, backend=backend, device="cpu", **kw),
                          (primal,), (tangent,))


@pytest.mark.parametrize("route", ["unrolled", "looped", "solver"])
def test_kernel_functions_take_forward_mode(route, monkeypatch):
    """Each kernel family's Function runs the kernel forward (its plain
    version on the CPU) and gives the eager tracer's tangent by its
    ``jvp``."""
    mod, cls = {"unrolled": (pmk, "PowerMapFunction"), "looped": (pml, "LoopedMapFunction"),
                "solver": (osk, "SolverMapFunction")}[route]
    fn = getattr(mod, cls)
    calls = []
    real = fn.jvp

    def spy(ctx, *a):
        calls.append(1)
        return real(ctx, *a)

    monkeypatch.setattr(fn, "jvp", staticmethod(spy))
    z, dz = _map_jvp(route, "auto")
    assert calls == [1]
    rz, rdz = _map_jvp(route, "torch")
    np.testing.assert_allclose(_np(z), _np(rz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dz), _np(rdz), rtol=1e-5, atol=1e-6)
    assert float(dz.abs().max()) > 0


def test_forward_ad_dual_tensors_raise_on_kernel_routes():
    """Dual tensors of ``torch.autograd.forward_ad`` never reach a kernel
    silently: the kernel routes raise; the eager route takes them."""
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(3, 2)
    _, ref = optimize.jvp(
        lambda t: power_map(scene.update_transmitters(tx=t), X, Y, max_order=1, approx=True,
                            backend="torch", device="cpu"),
        (scene.transmitters["tx"],), (torch.tensor([1.0, 0.0]),))
    with fwAD.dual_level():
        tx = fwAD.make_dual(scene.transmitters["tx"], torch.tensor([1.0, 0.0]))
        with pytest.raises(NotImplementedError, match="torch.func.jvp"):
            power_map(scene.update_transmitters(tx=tx), X, Y, max_order=1, approx=True,
                      device="cpu")
        z = power_map(scene.update_transmitters(tx=tx), X, Y, max_order=1, approx=True,
                      backend="torch", device="cpu")
        dual_tangent = fwAD.unpack_dual(z).tangent
    np.testing.assert_allclose(_np(dual_tangent), _np(ref), rtol=1e-5, atol=1e-6)
