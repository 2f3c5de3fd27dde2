"""Rules of the PyTorch port: isolation from JAX, device defaults, dispatch,
and the kernel route's autograd backward.

* ``differt2d_tpu_torch`` and every submodule import without JAX and
  without the JAX package (checked in a fresh interpreter).
* Entry points default to the GPU and raise without one, rather than
  quietly running on the CPU.
* :func:`differt2d_tpu_torch.tracer._kernel_eligible` gives the decisions of
  ``differt2d_tpu.tracer.power_map``'s Pallas dispatch on a TPU
  (``_pallas_eligible``, less the solver gradient maps it keeps on its
  tracer) and the kernel family of ``get_fused_run``'s stream-proxy rule or
  of the in-kernel solver, on a table of requests.
* The value kernel's ``autograd.Function`` backward, run on the CPU with
  the plain forward injected in place of the launch, gives the eager
  tracer's gradients.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS, Vertex
from differt2d_tpu.logic import sigmoid as jsigmoid
from differt2d_tpu.rt import path_candidate_matrices as jcands
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import (TypeCheckError, geometry, load_scene_arrays, models, optimize,
                                 parallel, power_map, prng)
from differt2d_tpu_torch import trace_paths
from differt2d_tpu_torch import tracer as ttracer
from differt2d_tpu_torch.logic import sigmoid as tsigmoid
from differt2d_tpu_torch.ops import opt_solver_kernel as osk
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.ops import power_map_looped as pml
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.tracer import make_pixels_fn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import differt2d_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'differt2d_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'differt2d_tpu' or m.startswith('differt2d_tpu.'))\n"
        "assert len(names) >= 12, names\n"
        "for m in ('prng', 'optimize', 'ops.opt_solver_kernel', 'abc', 'geometry', '_tree',\n"
        "          'checkpoint', 'profiling', 'parallel', 'parallel.sharding', 'parallel.launcher',\n"
        "          'parallel.supervisor', 'parallel.cand_sharded', 'parallel.wall_sharded',\n"
        "          'models', 'models.gflownet', 'rt._native'):\n"
        "    assert 'differt2d_tpu_torch.' + m in names, m\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scene.basic_scene()
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        power_map(scene, X, Y)
    assert power_map(scene, X, Y, device="cpu").shape == (4, 4)
    key = prng.PRNGKey(0)
    for entry in (Scene.square_scene_with_wall, Scene.square_scene_with_obstacle,
                  lambda: Scene.random_uniform_scene(key=key), lambda: Scene.from_objects(()),
                  lambda: Scene.from_scene_name("basic_scene"), geometry.Point,
                  lambda: geometry.from_numpy("Wall", xys=np.zeros((2, 2))),
                  lambda: optimize.minimize_random_uniform(lambda x: x.sum(), key, 2),
                  lambda: trace_paths(scene, torch.tensor([0.1, 0.1]), torch.tensor([0.2, 0.2])),
                  lambda: models.FlowNet(scene.num_objects)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert trace_paths(scene, torch.tensor([0.1, 0.1]), torch.tensor([0.2, 0.2]),
                       device="cpu")[1]["points"].shape == (7, 3, 2)
    # The parallel layer: each entry point resolves its device before it
    # touches a process group, so none is needed to see it raise.
    params = {"tx": torch.zeros(2, requires_grad=True)}
    for entry in (lambda: make_pixels_fn(scene),
                  lambda: parallel.power_map_sharded(scene, X, Y),
                  lambda: parallel.power_map_cand_sharded(scene, X, Y, mesh=None),
                  lambda: parallel.power_map_wall_sharded(scene, X, Y, mesh=None),
                  lambda: parallel.make_train_step(lambda p: scene,
                                                   torch.optim.Adam(params.values())),
                  lambda: parallel.initialize_distributed(),
                  lambda: parallel.initialize_from_env(num_processes=2, process_id=0,
                                                       coordinator_address="localhost:1")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert make_pixels_fn(scene, device="cpu")(torch.tensor([[0.5, 0.5]])).shape == (1,)
    # On the CPU the backend is gloo; world size 1 is a no-op.
    chosen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: chosen.append((backend, kw)))
    assert parallel.initialize_from_env(num_processes=1) is None
    dev = parallel.initialize_from_env(num_processes=2, process_id=1,
                                       coordinator_address="localhost:1", device="cpu")
    assert dev == torch.device("cpu")
    assert chosen == [("gloo", {"init_method": "tcp://localhost:1", "world_size": 2, "rank": 1})]


@functools.lru_cache(maxsize=None)
def _scenes():
    jbasic = JScene.basic_scene()
    jris = JScene.square_scene().add_objects(RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]])))
    jvert = JScene.square_scene().add_objects(
        Vertex(xy=jnp.array([0.3, 0.6])), Vertex(xy=jnp.array([0.7, 0.2]))
    )
    jcity = JScene.city_extract_scene()
    jsquare = JScene.square_scene()
    jscenes = {"basic": jbasic, "ris": jris, "vertex": jvert, "city": jcity, "square": jsquare}
    port = {}
    for name, js in jscenes.items():
        arr = jtracer.scene_arrays(js)
        port[name] = load_scene_arrays(
            np.asarray(arr.walls), np.asarray(arr.kind), np.asarray(arr.phi),
            {k: np.asarray(p.xy) for k, p in js.transmitters.items()},
            {k: np.asarray(p.xy) for k, p in js.receivers.items()}, device="cpu",
        )
    return jscenes, port


def _power(pts, order):  # a custom power model (any callable)
    return pts[..., 0, 0] * 0.0


# (scene, JAX kwargs, port kwargs, grad); None in port kwargs = same as JAX.
TABLE = [
    ("basic", {}, None, False),
    ("basic", {"max_order": 2}, None, False),
    ("basic", {"max_order": 2}, None, True),
    ("basic", {"max_order": 3}, None, False),
    ("basic", {"order": 0}, None, True),
    ("basic", {"power_fun": _power}, None, False),
    ("basic", {"many": 2}, None, False),
    ("basic", {"solver_grad": "implicit"}, None, False),
    ("basic", {"function": jsigmoid}, {"function": tsigmoid}, False),
    ("basic", {"function": jax.nn.relu}, {"function": torch.relu}, False),
    ("basic", {"alpha": jnp.array([1.0, 2.0])}, {"alpha": torch.tensor([1.0, 2.0])}, False),
    ("basic", {"alpha": jnp.array(5.0)}, {"alpha": torch.tensor(5.0, requires_grad=True)}, False),
    ("basic", {"on_transmitters": True}, None, True),
    ("ris", {}, None, False),
    ("ris", {"on_transmitters": True}, None, False),
    ("vertex", {"solver": "fermat", "order": 1, "filter_objects": "vertex"}, None, False),
    ("basic", {"solver": "mpt"}, None, False),
    ("city", {}, None, False),
    ("city", {}, None, True),
    ("city", {"approx": False}, None, True),
    ("city", {"function": jsigmoid}, {"function": tsigmoid}, False),
    ("city", {"on_transmitters": True}, None, True),
    ("city", {"max_order": 2}, None, False),
    ("city", {"order": 0}, None, False),
    # Fermat/MPT ("KEY": a key of the request's framework).
    ("square", {"solver": "fermat", "order": 1, "key": "KEY"}, None, False),
    ("square", {"solver": "mpt", "order": 1, "key": "KEY"}, None, False),
    ("square", {"solver": "mpt", "min_order": 0, "max_order": 1, "key": "KEY"}, None, False),
    ("square", {"solver": "fermat", "order": 1, "key": "KEY"}, None, True),
    ("square", {"solver": "mpt", "order": 1}, None, False),
    ("square", {"solver": "mpt", "max_order": 2, "key": "KEY"}, None, False),
    ("square", {"solver": "mpt", "order": 1, "key": "KEY", "many": 3}, None, False),
    ("square", {"solver": "fermat", "order": 1, "key": "KEY", "solver_grad": "implicit"}, None,
     False),
    ("square", {"solver": "fermat", "order": 1, "key": "KEY", "on_transmitters": True}, None,
     False),
    ("square", {"solver": "mpt", "order": 1, "key": "KEY", "function": jsigmoid},
     {"solver": "mpt", "order": 1, "key": "KEY", "function": tsigmoid}, False),
    ("ris", {"solver": "mpt", "order": 1, "key": "KEY", "filter_objects": "ris"}, None, False),
    ("ris", {"solver": "mpt", "order": 1, "key": "KEY", "on_transmitters": True}, None, False),
    ("vertex", {"solver": "fermat", "order": 1, "key": "KEY"}, None, False),
]


@pytest.mark.parametrize("row", range(len(TABLE)))
def test_kernel_eligible_matches_jax(row, monkeypatch):
    name, jkw, tkw, grad = TABLE[row]
    jscenes, tscenes = _scenes()
    js, ts = jscenes[name], tscenes[name]
    jkw = dict(jkw)
    tkw = dict(jkw if tkw is None else tkw)
    for kw, fw in ((jkw, jax.random.PRNGKey(0)), (tkw, prng.PRNGKey(0))):
        if kw.get("key") == "KEY":
            kw["key"] = fw
    if jkw.get("filter_objects") == "vertex":
        jkw["filter_objects"] = lambda o: isinstance(o, Vertex)
        tkw["filter_objects"] = lambda o: o.kind == 2
    if jkw.get("filter_objects") == "ris":
        jkw["filter_objects"] = lambda o: isinstance(o, RIS)
        tkw["filter_objects"] = lambda o: o.kind == 1
    # The JAX package's dispatch as it stands on a TPU (off one it keeps
    # Fermat/MPT on its tracer); gradient maps of a solver stay on its
    # tracer (tracer.power_map's _grad_on_solver).
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    solver = jkw.get("solver", "image")
    solved = solver != "image" and not jtracer._all_vertex_allowed(js, jkw.get("filter_objects"))
    expected = jtracer._pallas_eligible(js, jkw) and not (grad and solved)
    ok, reason = ttracer._kernel_eligible(ts, tkw, grad=grad)
    assert ok == expected, reason
    assert reason
    if ok and solved:
        assert reason.startswith("solver kernel") and "opt_solver_kernel" in reason, reason
    elif ok:
        # The unrolled/looped choice of get_fused_run on a TPU.
        arr = jtracer.scene_arrays(js)
        groups = jcands(arr.num_objects, min_order=jkw.get("min_order", 0),
                        max_order=jkw.get("max_order", 1), order=jkw.get("order"))
        proxy = sum(int(g.shape[0]) * arr.num_objects * (o + 1) for o, g in groups.items())
        unrolled = proxy <= (400 if grad else 1200)
        assert reason.startswith("unrolled") == unrolled, reason
        if not unrolled:
            # Every looped request names the port's looped kernels; their
            # order cap is the route's to apply.
            assert reason.startswith("looped") and "power_map_looped" in reason, reason


def test_solver_kernel_requests_are_named():
    """On a TPU, keyed order-1 Fermat/MPT maps go to the in-kernel solver
    (the JAX package keeps them on its tracer off a TPU); the port routes
    them to its solver kernel."""
    _, tscenes = _scenes()
    ok, reason = ttracer._kernel_eligible(
        tscenes["basic"], {"solver": "fermat", "key": 0, "order": 1}
    )
    assert ok and reason.startswith("solver kernel") and "opt_solver_kernel" in reason
    kw = {**ttracer._OPTIONS, "solver": "mpt", "key": prng.PRNGKey(0), "order": 1}
    groups = ttracer._groups_for(tscenes["square"], kw)
    assert ttracer._route(tscenes["square"], kw, groups, "auto", grad=False) == "solver"
    assert ttracer._route(tscenes["square"], kw, groups, "auto", grad=True) == "torch"
    ok, reason = ttracer._kernel_eligible(tscenes["basic"], {"solver": "mpt", "key": 0, "max_order": 2})
    assert not ok


def test_dispatch_routes_and_raises(monkeypatch):
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(6)
    # The order-2 gradient map and order-3 maps take the looped kernels (on
    # the CPU, their plain versions), as they take the JAX package's looped
    # kernel; order 5 is beyond the kernels' cap.
    calls = []
    for name in ("value", "value_and_grad"):
        real = getattr(pml, name)
        monkeypatch.setattr(pml, name, lambda *a, _real=real, _n=name, **k:
                            calls.append(_n) or _real(*a, **k))
    assert power_map(scene, X, Y, max_order=2, grad=True, device="cpu").shape == (6, 6, 2)
    assert power_map(scene, X, Y, max_order=3, device="cpu").shape == (6, 6)
    assert calls == ["value_and_grad", "value"]
    with pytest.raises(NotImplementedError, match="orders <= 4, got 5"):
        power_map(scene, X, Y, max_order=5, device="cpu")
    with pytest.raises(ValueError, match="power_fun"):
        power_map(scene, X, Y, power_fun=_power, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="requires a PRNG key"):
        power_map(scene, X, Y, solver="fermat", device="cpu")
    # Requests the JAX package sends to its tracer run on the eager tracer.
    assert float(power_map(scene, X, Y, power_fun=_power, device="cpu").abs().sum()) == 0.0
    z = power_map(scene, X, Y, max_order=2, grad=True, backend="torch", device="cpu")
    assert z.shape == (6, 6, 2)


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_fermat_raises_on_every_backend_with_the_jax_route(backend):
    """Keyed order-1 Fermat maps run on every backend (on the CPU the solver
    kernel's plain version is the eager solve, so all three agree); errors
    name where the JAX package runs the request: without a key, above order
    1 and with vertices the kernel route raises, and the tracer route raises
    for a missing key as the JAX tracer does."""
    scene = Scene.square_scene(device="cpu")
    X, Y = scene.grid(4)
    kw = dict(solver="fermat", order=1, steps=10, device="cpu")
    z = power_map(scene, X, Y, key=prng.PRNGKey(0), backend=backend, **kw)
    ref = power_map(scene, X, Y, key=prng.PRNGKey(0), backend="torch", **kw)
    torch.testing.assert_close(z, ref, rtol=0, atol=0)
    err = ValueError
    match = "does not cover.*without a key" if backend == "cuda" else "requires a PRNG key"
    with pytest.raises(err, match=match):
        power_map(scene, X, Y, solver="mpt", backend=backend, device="cpu")
    if backend == "cuda":
        with pytest.raises(ValueError, match="does not cover.*above order 1"):
            power_map(scene, X, Y, solver="mpt", max_order=2, key=prng.PRNGKey(0),
                      backend=backend, device="cpu")
        with pytest.raises(ValueError, match="does not cover.*with vertices"):
            power_map(scene.add_vertex([0.5, 0.5]), X, Y, key=prng.PRNGKey(0),
                      backend=backend, **kw)
    # An unknown solver fails power_map's check, as in the JAX package.
    with pytest.raises(TypeCheckError, match="Expected type: Literal"):
        power_map(scene, X, Y, solver="newton", backend=backend, device="cpu")


def test_solver_wrapper_raises_where_the_jax_kernel_raises():
    """``_opt_solver_map``'s errors (``pallas_kernels.py:3843-3871``)."""
    groups = {0: np.zeros((1, 0), np.int32), 1: np.arange(4, dtype=np.int32)[:, None]}
    kw = dict(solver="mpt", steps=10, approx=True, sigmoid=False)
    kinds = (0, 0, 0, 0)
    with pytest.raises(ValueError, match="orders <= 1"):
        osk.solver_inputs({**groups, 2: np.zeros((0, 2), np.int32)}, prng.PRNGKey(0), "cpu",
                          kinds=kinds, **kw)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        osk.solver_inputs(groups, None, "cpu", kinds=kinds, **kw)
    with pytest.raises(ValueError, match="vertex"):
        osk.solver_inputs(groups, prng.PRNGKey(0), "cpu", kinds=(0, 0, 2, 0), **kw)
    inputs = osk.solver_inputs(groups, prng.PRNGKey(0), "cpu", kinds=kinds, **kw)
    assert inputs is osk.solver_inputs(groups, prng.PRNGKey(0), "cpu", kinds=kinds, **kw)
    assert inputs is not osk.solver_inputs(groups, prng.PRNGKey(1), "cpu", kinds=kinds, **kw)
    assert inputs.cand.tolist() == [0, 1, 2, 3] and inputs.los is not None
    assert inputs.bc.shape == (20,) and inputs.x0.shape == (4,)
    assert osk.kernel_caps_reason(osk.MAX_WALLS + 1, 1) is not None
    assert "orders <= 1" in osk.kernel_caps_reason(4, 2)


def test_kernel_caps_match_the_cuda_source():
    csrc = os.path.join(ROOT, "differt2d_tpu_torch", "ops", "csrc")
    for source, caps in (
        ("power_map.cu", (("PM_MAX_ORDER", pmk.MAX_ORDER), ("PM_MAX_WALLS", pmk.MAX_WALLS))),
        ("opt_solver.cu", (("OS_MAX_WALLS", osk.MAX_WALLS),)),
    ):
        with open(os.path.join(csrc, source)) as f:
            src = f.read()
        for name, value in caps:
            assert f"#define {name} {value}\n" in src, name


def test_requests_above_the_kernel_caps_raise():
    rng = np.random.default_rng(3)
    many = Scene.from_arrays(rng.uniform(0, 1, (pmk.MAX_WALLS + 1, 2, 2)).astype(np.float32),
                             transmitters={"tx": [0.5, 0.5]}, device="cpu")
    X, Y = many.grid(3)
    with pytest.raises(NotImplementedError, match=f"at most {pmk.MAX_WALLS} objects"):
        power_map(many, X, Y, order=0, device="cpu")
    assert power_map(many, X, Y, order=0, backend="torch", device="cpu").shape == (3, 3)
    assert pmk.kernel_caps_reason(pmk.MAX_WALLS, pmk.MAX_ORDER) is None
    assert "orders <=" in pmk.kernel_caps_reason(7, pmk.MAX_ORDER + 1)


def test_vertex_only_fermat_runs_the_image_path():
    _, tscenes = _scenes()
    ts = tscenes["vertex"]
    X, Y = ts.grid(6)
    flt = lambda o: o.kind == 2  # noqa: E731
    a = power_map(ts, X, Y, order=1, solver="fermat", filter_objects=flt, device="cpu")
    b = power_map(ts, X, Y, order=1, filter_objects=flt, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_inputs_cache_is_keyed_on_content():
    kw = dict(ttracer._OPTIONS)

    def inputs(scene):
        return pmk.kernel_inputs(ttracer._groups_for(scene, kw), "cpu",
                                 approx=True, sigmoid=False)

    a = Scene.basic_scene(device="cpu")
    b = Scene.basic_scene(tx_coords=(0.3, 0.3), device="cpu")
    assert inputs(a) is inputs(b)  # two scene objects, one structure
    assert inputs(a.add_vertex([0.5, 0.5])) is not inputs(a)
    assert inputs(a).cand.shape == (8, pmk.MAX_ORDER + 1)
    assert inputs(a).cand[:, 0].tolist() == [0] + [1] * 7


def test_autograd_function_backward_with_injected_forward(monkeypatch):
    calls = []

    def injected(px, py, txs, walls, kind, phi, scalars, inputs, *, approx, sigmoid):
        calls.append(px.shape)
        return pmk.plain_value(px, py, txs, walls, kind, phi, scalars, inputs)

    monkeypatch.setattr(pmk, "value", injected)
    X, Y = Scene.basic_scene(device="cpu").grid(12, 9)

    def grads(backend):
        base = Scene.basic_scene(device="cpu")
        walls = base.walls.clone().requires_grad_(True)
        tx = torch.tensor([0.1, 0.1], requires_grad=True)
        phi = base.phi.clone().requires_grad_(True)
        alpha = torch.tensor(100.0, requires_grad=True)
        height = torch.tensor(0.1, requires_grad=True)
        xg = X.clone().requires_grad_(True)
        sc = Scene.from_arrays(walls, base.kind, phi, {"tx": tx}, device="cpu")
        Z = power_map(sc, xg, Y, max_order=1, approx=True, alpha=alpha, height=height,
                      backend=backend, device="cpu")
        return (Z, *torch.autograd.grad((Z * Z).sum(), (walls, tx, phi, alpha, height, xg)))

    got = grads("auto")
    assert calls, "the injected forward did not run"
    ref = grads("torch")
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


# -- the public surface: every name of the JAX package has its counterpart -----------

# JAX names whose counterpart lives under another name or module of the port
# (checked to exist there).
ELSEWHERE = {
    # Aliases for annotations and literal sets, kept as tuples of values.
    "differt2d_tpu.abc.Loc": "differt2d_tpu_torch.abc.LOCATIONS",
    "differt2d_tpu.scene.SceneName": "differt2d_tpu_torch.scene.SCENE_NAMES",
    # The Pallas modules' constants and entry points: the port's kernel
    # wrappers, culling tables and dispatch.
    "differt2d_tpu.ops.pallas_kernels.KIND_WALL": "differt2d_tpu_torch.defaults.KIND_WALL",
    "differt2d_tpu.ops.pallas_kernels.KIND_RIS": "differt2d_tpu_torch.defaults.KIND_RIS",
    "differt2d_tpu.ops.pallas_kernels.KIND_VERTEX": "differt2d_tpu_torch.defaults.KIND_VERTEX",
    "differt2d_tpu.ops.pallas_kernels.TILE": "differt2d_tpu_torch.ops.power_map_looped.TILE",
    "differt2d_tpu.ops.pallas_kernels.build_power_map_kernel":
        "differt2d_tpu_torch.ops.power_map_kernel.power_map_kernel",
    "differt2d_tpu.ops.pallas_kernels.build_power_map_kernel_looped":
        "differt2d_tpu_torch.ops.power_map_looped.power_map_looped",
    "differt2d_tpu.ops.pallas_kernels.beam_keep_tables":
        "differt2d_tpu_torch.ops.cull_tables.beam_keep_tables",
    "differt2d_tpu.ops.pallas_kernels.first_wall_visibility_dead":
        "differt2d_tpu_torch.ops.cull_tables.first_wall_visibility_dead",
    "differt2d_tpu.ops.pallas_kernels.pair_occlusion_dead":
        "differt2d_tpu_torch.ops.cull_tables.pair_occlusion_dead",
    "differt2d_tpu.ops.pallas_kernels.shadow_wall_lists":
        "differt2d_tpu_torch.ops.cull_tables.shadow_wall_lists",
    "differt2d_tpu.ops.pallas_kernels.pallas_power_map": "differt2d_tpu_torch.tracer.map_groups",
    "differt2d_tpu.ops.pallas_kernels.get_fused_run": "differt2d_tpu_torch.tracer._route",
    "differt2d_tpu.ops.pallas_solver.build_opt_order1_kernel":
        "differt2d_tpu_torch.ops.opt_solver_kernel.solver_map",
    "differt2d_tpu.ops.pallas_solver.ADAM_B1": "differt2d_tpu_torch.optimize.ADAM_B1",
    "differt2d_tpu.ops.pallas_solver.ADAM_B2": "differt2d_tpu_torch.optimize.ADAM_B2",
    "differt2d_tpu.ops.pallas_solver.ADAM_EPS": "differt2d_tpu_torch.optimize.ADAM_EPS",
    "differt2d_tpu.ops.pallas_solver.ADAM_EPS_ROOT": "differt2d_tpu_torch.optimize.ADAM_EPS_ROOT",
    "differt2d_tpu.ops.pallas_solver.ADAM_LR": "differt2d_tpu_torch.optimize.ADAM_LR",
}

# JAX names with no counterpart, and why.
NOT_PORTED = {
    # JAX PyTree plumbing (ROADMAP "Do not port"): a port scene keeps dicts.
    "differt2d_tpu._module.*": "PyTree dataclass helpers of JAX",
    "differt2d_tpu.scene.PyTreeDict": "PyTree plumbing",
    # Annotation aliases of jax.Array.
    "differt2d_tpu._typing.*": "annotation aliases of jax.Array",
    "differt2d_tpu.logic.Truthy": "annotation alias of jax.Array",
    "differt2d_tpu.scene.PathFun": "annotation alias",
    # A spec the JAX package declares and applies nowhere (from_geojson is
    # deliberately unchecked there).
    "differt2d_tpu._runtime_typing.GEOJSON_SOURCE": "unused in the JAX package",
    # TPU vreg layout (8 sublanes x 128 lanes): no meaning on a GPU.
    "differt2d_tpu.ops.pallas_kernels.SUBLANES": "TPU layout",
    "differt2d_tpu.ops.pallas_kernels.LANES": "TPU layout",
    # The 8-wall chunk words (ROADMAP "Do not port"): per-wall bit words.
    "differt2d_tpu.ops.pallas_kernels.MID_CHUNK": "8-wall chunk words",
    "differt2d_tpu.ops.pallas_kernels.shadow_chunk_words": "8-wall chunk words",
    "differt2d_tpu.ops.pallas_kernels.mid_pair_masks": "8-wall chunk words",
}


def _jax_public_names() -> dict:
    """``{dotted JAX name: whether it is a class}`` and ``{class method: its
    class}``: the public top-level names each module of ``differt2d_tpu``
    defines (functions, classes, assignments) and the public methods of its
    public classes."""
    import ast
    import pathlib

    names, methods = {}, {}
    pkg = pathlib.Path(ROOT) / "differt2d_tpu"
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        module = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                found = [node.name]
            elif isinstance(node, ast.Assign):
                found = [t.id for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                found = [node.target.id]
            else:
                found = []
            for name in found:
                if name.startswith("_"):
                    continue
                names[f"{module}.{name}"] = isinstance(node, ast.ClassDef)
                if isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef) and not item.name.startswith("_"):
                            methods[f"{module}.{name}.{item.name}"] = f"{module}.{name}"
    return names, methods


def _port_object(dotted: str):
    """The object at ``dotted`` (module path, then attributes), or None."""
    import importlib

    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            if not hasattr(obj, attr):
                return None
            obj = getattr(obj, attr)
        return obj
    return None


def _counterpart(name: str) -> str:
    return name.replace("differt2d_tpu", "differt2d_tpu_torch", 1)


def _not_ported(name: str) -> bool:
    return name in NOT_PORTED or f"{name.rsplit('.', 1)[0]}.*" in NOT_PORTED


def test_public_surface_census():
    """Every public name of every module of ``differt2d_tpu`` (and every
    public method of its classes) has its counterpart in the same module
    of ``differt2d_tpu_torch``, or one listed in ``ELSEWHERE``, or is in
    ``NOT_PORTED`` with its reason; and each listed exception is one the
    census needs."""
    names, methods = _jax_public_names()
    assert len(names) > 150 and len(methods) > 80, (len(names), len(methods))
    missing, needed = [], set()
    for name in names:
        if _port_object(_counterpart(name)) is not None:
            continue
        if name in ELSEWHERE:
            needed.add(name)
            if _port_object(ELSEWHERE[name]) is None:
                missing.append(f"{name} -> {ELSEWHERE[name]}")
        elif _not_ported(name):
            needed.add(name if name in NOT_PORTED else f"{name.rsplit('.', 1)[0]}.*")
        else:
            missing.append(name)
    for method, cls in methods.items():
        if cls in ELSEWHERE or _not_ported(cls):
            continue
        if _port_object(_counterpart(method)) is None:
            missing.append(method)
    assert not missing, missing
    assert needed == set(ELSEWHERE) | set(NOT_PORTED), sorted(
        (set(ELSEWHERE) | set(NOT_PORTED)) - needed)
