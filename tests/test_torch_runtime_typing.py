"""The port's runtime type checks against the JAX package's.

Every case of ``tests/test_runtime_typing.py`` has its counterpart here, on
tensors: each misuse is made on both sides, both raise their
``TypeCheckError`` and the labels after "Expected type:" start with the
same word (``Bool``, ``Union``, ``Optional``, ``Literal``, ``Callable``,
``PRNGKeyArray``, ``int``, ``Float``).  The checks run inside
``torch.func.grad`` and ``torch.func.vmap`` as the JAX ones run at trace
time, and ``no_typecheck`` turns them off.  Checks are paid at the public
entry points only: the eager tracer, ``ops/``, ``parallel/`` and the
autograd Functions reach no checked function, which a scan of their code
and a count of the checks one map pays both show.
"""

import ast
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt2d_tpu.logic as jlogic
from differt2d_tpu import TypeCheckError as JTypeCheckError
from differt2d_tpu import geometry as jgeometry
from differt2d_tpu import no_typecheck as jno_typecheck
from differt2d_tpu import optimize as joptimize
from differt2d_tpu import rt as jrt
from differt2d_tpu import tracer as jtracer
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu.utils import received_power as jreceived_power

import differt2d_tpu_torch
import differt2d_tpu_torch.logic as tlogic
from differt2d_tpu_torch import TypeCheckError, geometry, no_typecheck, optimize, prng, rt
from differt2d_tpu_torch import set_typecheck, tracer
from differt2d_tpu_torch import _runtime_typing
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import received_power

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_jax_cache():
    # The JAX package resolves approx=None at trace time (as in its own test).
    jlogic.is_true.clear_cache()
    jlogic.is_false.clear_cache()
    yield
    jlogic.is_true.clear_cache()
    jlogic.is_false.clear_cache()


def _lead(exc: BaseException) -> str:
    """The first word of the label after "Expected type: "."""
    return re.match(r"\w+", str(exc).split("Expected type: ", 1)[1]).group(0)


def both_raise(jax_call, port_call, match: str = "Expected type") -> str:
    """Both calls raise their package's TypeCheckError matching ``match``;
    the labels' leading words agree.  Returns the port's message."""
    with pytest.raises(JTypeCheckError, match=match) as j:
        jax_call()
    with pytest.raises(TypeCheckError, match=match) as t:
        port_call()
    if "Expected type: " in str(j.value):
        assert _lead(t.value) == _lead(j.value), (str(t.value), str(j.value))
    return str(t.value)


def test_is_true_hard_float_raises():
    for value in [0.0, 0.5, 1.0]:
        jlogic.is_true.clear_cache()
        with jlogic.enable_approx(False), tlogic.enable_approx(False):
            both_raise(lambda: jlogic.is_true(value), lambda: tlogic.is_true(value),
                       "Expected type: Bool")
    for value in [True, False]:
        with tlogic.enable_approx(False):
            out = tlogic.is_true(value)
        assert out.dtype == torch.bool and bool(out) is value


def test_is_true_explicit_keyword():
    assert bool(tlogic.is_true(1.0, approx=True))
    both_raise(lambda: jlogic.is_true(1.0, approx=False),
               lambda: tlogic.is_true(1.0, approx=False), "Expected type: Bool")
    assert bool(tlogic.is_true(True, approx=False))


def test_disable_approx_context():
    with jlogic.disable_approx(True), tlogic.disable_approx(True):
        both_raise(lambda: jlogic.is_true(0.5), lambda: tlogic.is_true(0.5),
                   "Expected type: Bool")


def test_soft_mode_accepts_floats():
    with tlogic.enable_approx(True):
        out = tlogic.is_true(1.0)
        assert out.dtype == torch.bool and bool(out)
        assert not bool(tlogic.is_false(1.0, approx=True))


def test_approx_param_must_be_bool():
    both_raise(lambda: jlogic.greater(1.0, 0.0, approx="yes"),
               lambda: tlogic.greater(1.0, 0.0, approx="yes"), "Expected type: Optional")


def test_float_params_reject_int_arrays():
    both_raise(lambda: jlogic.greater(jnp.array([1, 2]), 0.0, approx=True),
               lambda: tlogic.greater(torch.tensor([1, 2]), 0.0, approx=True),
               "Expected type: Union")


def test_truthy_params_reject_garbage():
    both_raise(lambda: jlogic.logical_and(object(), 1.0, approx=True),
               lambda: tlogic.logical_and(object(), 1.0, approx=True))


def test_checks_run_inside_torch_func_grad():
    """The counterpart of ``test_checks_run_at_trace_time_inside_jit``: the
    wrapped tensors of ``torch.func.grad`` keep their dtype."""

    @jax.jit
    def collapse(x):
        return jlogic.is_true(x, approx=False)

    both_raise(lambda: collapse(jnp.array(0.5)),
               lambda: torch.func.grad(lambda x: x * tlogic.is_true(x, approx=False))(
                   torch.tensor(0.5)),
               "Expected type: Bool")
    assert bool(collapse(jnp.array(True)))
    g = torch.func.grad(lambda x: x * tlogic.is_true(x > 0.0, approx=False))(torch.tensor(0.5))
    assert float(g) == 1.0


def test_vmap_over_batched_args_is_allowed():
    xs = torch.linspace(0.0, 1.0, 8)
    assert torch.func.vmap(lambda x: tlogic.greater(x, 0.5, approx=True))(xs).shape == (8,)
    # A per-example scalar is 0-d inside vmap, so the scalar rule holds.
    alphas = torch.tensor([1.0, 2.0])
    out = torch.func.vmap(lambda a: tlogic.hard_sigmoid(torch.ones(3), a))(alphas)
    assert out.shape == (2, 3)
    both_raise(lambda: jax.vmap(lambda x: jlogic.is_true(x, approx=False))(jnp.ones(3)),
               lambda: torch.func.vmap(lambda x: tlogic.is_true(x, approx=False))(
                   torch.ones(3)),
               "Expected type: Bool")


def test_loc_literal():
    wall = geometry.Wall(xys=torch.tensor([[0.0, 0.0], [1.0, 1.0]]))
    assert wall.get_location("NW").shape == (2,)
    jwall = jgeometry.Wall(xys=jnp.array([[0.0, 0.0], [1.0, 1.0]]))
    both_raise(lambda: jwall.get_location("L"), lambda: wall.get_location("L"),
               "Expected type: Literal")


def test_get_location_invalid():
    """``tests/test_abc.py``'s case: an invalid ``Loc`` literal raises."""
    both_raise(lambda: jgeometry.Point().get_location("X"),
               lambda: geometry.Point(xy=torch.zeros(2)).get_location("X"),
               "Expected type: Literal")
    city = Scene.city_extract_scene(device="cpu")
    with pytest.raises(TypeCheckError, match="Expected type: Literal"):
        city.get_location("X")


def test_no_typecheck_scope():
    with no_typecheck():
        out = tlogic.is_true(1.0, approx=False)
    assert float(out) == 1.0
    with jno_typecheck():
        assert float(jlogic.is_true(1.0, approx=False)) == 1.0
    # set_typecheck sets the thread's state, which no_typecheck restores.
    set_typecheck(False)
    try:
        tlogic.is_true(0.5, approx=False)
    finally:
        set_typecheck(True)
    with pytest.raises(TypeCheckError):
        tlogic.is_true(0.5, approx=False)


def test_disable_switch_in_the_environment():
    code = ("import differt2d_tpu_torch.logic as l\n"
            "print(float(l.is_true(0.5, approx=False)))\n")
    env = {**os.environ, "DIFFERT2D_TPU_DISABLE_TYPECHECK": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0 and proc.stdout.strip() == "0.5", proc.stderr


def test_extension_float_dtypes_accepted():
    for dtype in (torch.bfloat16, torch.float16):
        out = tlogic.greater(torch.tensor([0.1, 0.9], dtype=dtype), 0.5, approx=True)
        assert out.shape == (2,)
    assert jlogic.greater(jnp.array([0.1, 0.9], dtype=jnp.bfloat16), 0.5, approx=True).shape == (2,)


def test_unknown_spec_name_raises_at_decoration():
    with pytest.raises(TypeError, match="match no parameter"):

        @_runtime_typing.typecheck(aplha=_runtime_typing.SCALAR_FLOAT)  # typo'd on purpose
        def f(alpha):
            return alpha


# -- every public module raises TypeCheckError on a misuse, as the JAX one -------


class TestFullAPISurface:
    def test_geometry_segments_intersect_bad_point(self):
        jp, tp = jnp.zeros(2), torch.zeros(2)
        both_raise(lambda: jgeometry.segments_intersect(jp, jp, jp, jnp.zeros(3)),
                   lambda: geometry.segments_intersect(tp, tp, tp, torch.zeros(3)))
        both_raise(lambda: jgeometry.segments_intersect(jp, jp, jp, "not-an-array"),
                   lambda: geometry.segments_intersect(tp, tp, tp, "not-an-array"))

    def test_geometry_path_length_int_array(self):
        both_raise(lambda: jgeometry.path_length(jnp.zeros((3, 2), dtype=jnp.int32)),
                   lambda: geometry.path_length(torch.zeros(3, 2, dtype=torch.int32)))

    def test_geometry_solver_classmethods_bad_tx(self):
        jwall = jgeometry.Wall(xys=jnp.array([[0.0, 1.0], [1.0, 1.0]]))
        wall = geometry.Wall(xys=torch.tensor([[0.0, 1.0], [1.0, 1.0]]))
        jrx, rx = jnp.array([2.0, 0.0]), torch.tensor([2.0, 0.0])
        both_raise(lambda: jgeometry.ImagePath.from_tx_objects_rx((0.0, 0.0), [jwall], jrx),
                   lambda: geometry.ImagePath.from_tx_objects_rx((0.0, 0.0), [wall], rx))
        for name in ("FermatPath", "MinPath"):
            jcls, tcls = getattr(jgeometry, name), getattr(geometry, name)
            both_raise(lambda: jcls.from_tx_objects_rx(jnp.zeros(2), [jwall], jrx, key=1234),
                       lambda: tcls.from_tx_objects_rx(torch.zeros(2), [wall], rx, key=1234),
                       "Expected type: PRNGKey")

    def test_optimize_minimize_bad_fun(self):
        both_raise(lambda: joptimize.minimize("not-callable", jnp.zeros(2)),
                   lambda: optimize.minimize("not-callable", torch.zeros(2)),
                   "Expected type: Callable")
        both_raise(lambda: joptimize.minimize(lambda x: jnp.sum(x**2), jnp.zeros(2), steps=10.5),
                   lambda: optimize.minimize(lambda x: torch.sum(x**2), torch.zeros(2),
                                             steps=10.5))

    def test_optimize_random_uniform_bad_key(self):
        both_raise(lambda: joptimize.minimize_random_uniform(lambda x: jnp.sum(x**2), 1234, 2),
                   lambda: optimize.minimize_random_uniform(lambda x: torch.sum(x**2), 1234, 2),
                   "Expected type: PRNGKey")
        # A signed integer key is no PRNG key on either side.
        both_raise(lambda: joptimize.minimize_random_uniform(
                       lambda x: jnp.sum(x**2), jnp.array([0, 1234], jnp.int32), 2),
                   lambda: optimize.minimize_random_uniform(
                       lambda x: torch.sum(x**2), torch.tensor([0, 1234]), 2, device="cpu"),
                   "Expected type: PRNGKey")

    def test_scene_factory_bad_key(self):
        both_raise(lambda: JScene.random_uniform_scene(key=42),
                   lambda: Scene.random_uniform_scene(key=42, device="cpu"),
                   "Expected type: PRNGKey")
        both_raise(lambda: JScene.random_uniform_scene(n_walls=2.5, key=jax.random.PRNGKey(0)),
                   lambda: Scene.random_uniform_scene(n_walls=2.5, key=prng.PRNGKey(0),
                                                      device="cpu"),
                   "Expected type: int")

    def test_scene_accumulators_bad_args(self):
        jscene, scene = JScene.square_scene(), Scene.square_scene(device="cpu")
        jX, jY = jnp.meshgrid(jnp.linspace(0.2, 0.8, 3), jnp.linspace(0.2, 0.8, 3))
        X, Y = torch.meshgrid(torch.linspace(0.2, 0.8, 3), torch.linspace(0.2, 0.8, 3),
                              indexing="xy")
        both_raise(lambda: jscene.accumulate_on_receivers_grid_over_paths(jX, jY,
                                                                          fun="not-callable"),
                   lambda: scene.accumulate_on_receivers_grid_over_paths(X, Y,
                                                                         fun="not-callable"),
                   "Expected type: Callable")
        both_raise(lambda: jscene.accumulate_on_transmitters_grid_over_paths(
                       jX.astype(jnp.int32), jY.astype(jnp.int32), fun=jreceived_power),
                   lambda: scene.accumulate_on_transmitters_grid_over_paths(
                       X.to(torch.int32), Y.to(torch.int32), fun=received_power))
        both_raise(lambda: jscene.accumulate_over_paths(jreceived_power, approx="yes"),
                   lambda: scene.accumulate_over_paths(received_power, approx="yes"))

    def test_scene_all_path_candidates_bad_order(self):
        both_raise(lambda: JScene.square_scene().all_path_candidates(max_order=1.5),
                   lambda: Scene.square_scene(device="cpu").all_path_candidates(max_order=1.5),
                   "Expected type: int")

    def test_tracer_power_map_bad_solver_and_backend(self):
        jscene, scene = JScene.square_scene(), Scene.square_scene(device="cpu")
        jX, jY = jnp.meshgrid(jnp.linspace(0.2, 0.8, 3), jnp.linspace(0.2, 0.8, 3))
        X, Y = torch.meshgrid(torch.linspace(0.2, 0.8, 3), torch.linspace(0.2, 0.8, 3),
                              indexing="xy")
        both_raise(lambda: jtracer.power_map(jscene, jX, jY, solver="newton"),
                   lambda: tracer.power_map(scene, X, Y, solver="newton", device="cpu"),
                   "Expected type: Literal")
        # Each package's own backend set: the JAX one has no "cuda", the
        # port no "xla".
        both_raise(lambda: jtracer.power_map(jscene, jX, jY, backend="cuda"),
                   lambda: tracer.power_map(scene, X, Y, backend="xla", device="cpu"),
                   "Expected type: Literal")
        both_raise(lambda: jtracer.power_map(jscene, jX, jY[:2, :]),
                   lambda: tracer.power_map(scene, X, Y[:2, :], device="cpu"), "same shape")

    def test_tracer_trace_paths_bad_rx(self):
        both_raise(lambda: jtracer.trace_paths(JScene.square_scene(), jnp.zeros(2), jnp.zeros(3),
                                               max_order=1),
                   lambda: tracer.trace_paths(Scene.square_scene(device="cpu"), torch.zeros(2),
                                              torch.zeros(3), max_order=1, device="cpu"))

    def test_utils_received_power_bad_scalars(self):
        jpath = jgeometry.Path(xys=jnp.array([[0.0, 0.0], [1.0, 0.0]]))
        path = geometry.Path(xys=torch.tensor([[0.0, 0.0], [1.0, 0.0]]))
        both_raise(lambda: jreceived_power(None, None, jpath, [], r_coef="0.5"),
                   lambda: received_power(None, None, path, [], r_coef="0.5"))
        both_raise(lambda: jreceived_power(None, None, jpath, [], height=jnp.zeros(3)),
                   lambda: received_power(None, None, path, [], height=torch.zeros(3)))

    def test_rt_bad_num_nodes(self):
        both_raise(lambda: jrt.all_path_candidates(3.0, max_order=1),
                   lambda: rt.all_path_candidates(3.0, max_order=1), "Expected type: int")
        both_raise(lambda: jrt.path_candidate_matrices(4, min_order=0, max_order=True),
                   lambda: rt.path_candidate_matrices(4, min_order=0, max_order=True),
                   "Expected type: int")

    def test_no_typecheck_scope_covers_new_surface(self):
        with no_typecheck():
            x, _ = optimize.minimize(lambda x: torch.sum((x - 1.0) ** 2), torch.zeros(2))
            # Unchecked, an int-typed step count is the int it holds.
            assert rt.path_candidate_matrices(4, 0, np.int64(1))[1].shape == (4, 1)
        assert torch.allclose(x, torch.ones(2), rtol=1e-2)


# -- checks at the public entry points only --------------------------------------------


def _modules_without_checks() -> list:
    """The eager tracer, every module of ``ops/`` and of ``parallel/``."""
    names = ["differt2d_tpu_torch.eager"]
    for pkg in ("ops", "parallel"):
        path = os.path.join(os.path.dirname(differt2d_tpu_torch.__file__), pkg)
        names += [f"differt2d_tpu_torch.{pkg}.{m.name}" for m in pkgutil.iter_modules([path])]
        names.append(f"differt2d_tpu_torch.{pkg}")
    return [importlib.import_module(n) for n in names]


def _checked(obj) -> bool:
    return getattr(obj, "__typechecked__", False)


def test_internal_modules_reach_only_unchecked_bodies():
    """No name of the eager tracer, ``ops/`` or ``parallel/`` is bound to a
    checked function, and none reads one off a module (``logic.sigmoid``)
    except to pass it to ``unchecked``."""
    bad = []
    for mod in _modules_without_checks():
        bad += [f"{mod.__name__}.{k}" for k, v in vars(mod).items() if _checked(v)]
        tree = ast.parse(inspect.getsource(mod))
        wrapped = {id(arg) for node in ast.walk(tree) if isinstance(node, ast.Call)
                   and isinstance(node.func, ast.Name) and node.func.id == "unchecked"
                   for arg in node.args}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and id(node) not in wrapped):
                owner = vars(mod).get(node.value.id)
                if inspect.ismodule(owner) and _checked(getattr(owner, node.attr, None)):
                    bad.append(f"{mod.__name__}: {node.value.id}.{node.attr}")
    assert not bad, bad
    # The activation every kernel wrapper hands to its plain version.
    assert not _checked(tracer._OPTIONS["function"])


def test_a_map_pays_one_check(monkeypatch):
    """Each route of ``power_map`` (the unrolled, looped and solver kernels'
    plain versions, the eager tracer, autograd through the kernel's
    Function) checks the map's own arguments once and nothing below it,
    also when the request names the public, checked activation."""
    calls = []
    real = _runtime_typing._enabled
    monkeypatch.setattr(_runtime_typing, "_enabled", lambda: calls.append(1) or real())
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(6, 5)
    walls = scene.walls.detach().clone().requires_grad_(True)
    grads = Scene.from_arrays(walls, transmitters=scene.transmitters, device="cpu")
    ris = Scene.square_scene(device="cpu").add_ris([[0.5, 0.3], [0.5, 0.7]])
    requests = {
        "unrolled": (scene, dict(approx=True)),
        "unrolled, sigmoid": (scene, dict(approx=True, function=tlogic.sigmoid)),
        "unrolled, value and gradient": (scene, dict(approx=True, value_and_grad=True)),
        "looped": (scene, dict(max_order=2, approx=True)),
        "solver": (ris, dict(order=1, solver="mpt", steps=5, approx=True, key=prng.PRNGKey(0),
                             filter_objects=lambda o: o.kind == 1)),
        "eager": (scene, dict(approx=True, backend="torch", function=tlogic.hard_sigmoid)),
        "autograd": (grads, dict(approx=True)),
    }
    for name, (sc, kw) in requests.items():
        calls.clear()
        out = tracer.power_map(sc, X, Y, device="cpu", **kw)
        if name == "autograd":
            out.sum().backward()
            assert walls.grad is not None
        assert len(calls) == 1, (name, len(calls))
    calls.clear()
    tracer.trace_paths(scene, torch.tensor([0.1, 0.1]), torch.tensor([0.5, 0.5]),
                       approx=True, function=tlogic.sigmoid, device="cpu")
    assert len(calls) == 1
