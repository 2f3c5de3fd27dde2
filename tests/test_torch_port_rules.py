"""Rules of the PyTorch port: isolation from JAX, device defaults, dispatch,
and the kernel route's autograd backward.

* ``differt2d_tpu_torch`` and every submodule import without JAX and
  without the JAX package (checked in a fresh interpreter).
* Entry points default to the GPU and raise without one, rather than
  quietly running on the CPU.
* :func:`differt2d_tpu_torch.tracer._kernel_eligible` gives the decisions of
  ``differt2d_tpu.tracer._pallas_eligible`` (and the kernel family of
  ``get_fused_run``'s stream-proxy rule) on a table of requests.
* The value kernel's ``autograd.Function`` backward, run on the CPU with
  the plain forward injected in place of the launch, gives the eager
  tracer's gradients.
"""

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
from differt2d_tpu_torch import load_scene_arrays, power_map
from differt2d_tpu_torch import tracer as ttracer
from differt2d_tpu_torch.logic import sigmoid as tsigmoid
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.scene import Scene

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
        "assert len(names) >= 9, names\n"
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


def _scenes():
    jbasic = JScene.basic_scene()
    jris = JScene.square_scene().add_objects(RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]])))
    jvert = JScene.square_scene().add_objects(
        Vertex(xy=jnp.array([0.3, 0.6])), Vertex(xy=jnp.array([0.7, 0.2]))
    )
    port = {}
    for name, js in (("basic", jbasic), ("ris", jris), ("vertex", jvert)):
        arr = jtracer.scene_arrays(js)
        port[name] = load_scene_arrays(
            np.asarray(arr.walls), np.asarray(arr.kind), np.asarray(arr.phi),
            {k: np.asarray(p.xy) for k, p in js.transmitters.items()},
            {k: np.asarray(p.xy) for k, p in js.receivers.items()}, device="cpu",
        )
    return {"basic": jbasic, "ris": jris, "vertex": jvert}, port


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
]


@pytest.mark.parametrize("row", range(len(TABLE)))
def test_kernel_eligible_matches_jax(row):
    name, jkw, tkw, grad = TABLE[row]
    jscenes, tscenes = _scenes()
    js, ts = jscenes[name], tscenes[name]
    jkw = dict(jkw)
    tkw = dict(jkw if tkw is None else tkw)
    if jkw.get("filter_objects") == "vertex":
        jkw["filter_objects"] = lambda o: isinstance(o, Vertex)
        tkw["filter_objects"] = lambda o: o.kind == 2
    expected = jtracer._pallas_eligible(js, jkw)
    ok, reason = ttracer._kernel_eligible(ts, tkw, grad=grad)
    assert ok == expected, reason
    assert reason
    if ok:
        # The unrolled/looped choice of get_fused_run on a TPU.
        arr = jtracer.scene_arrays(js)
        groups = jcands(arr.num_objects, min_order=jkw.get("min_order", 0),
                        max_order=jkw.get("max_order", 1), order=jkw.get("order"))
        proxy = sum(int(g.shape[0]) * arr.num_objects * (o + 1) for o, g in groups.items())
        unrolled = proxy <= (400 if grad else 1200)
        assert reason.startswith("unrolled") == unrolled, reason


def test_solver_kernel_requests_are_named():
    """On a TPU, keyed order-1 Fermat/MPT maps go to the in-kernel solver
    (the JAX package keeps them on its tracer off a TPU)."""
    _, tscenes = _scenes()
    ok, reason = ttracer._kernel_eligible(
        tscenes["basic"], {"solver": "fermat", "key": 0, "order": 1}
    )
    assert ok and reason.startswith("solver kernel") and "item 9" in reason
    ok, reason = ttracer._kernel_eligible(tscenes["basic"], {"solver": "mpt", "key": 0, "max_order": 2})
    assert not ok


def test_dispatch_routes_and_raises():
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(6)
    with pytest.raises(NotImplementedError, match="looped kernel"):
        power_map(scene, X, Y, max_order=2, grad=True, device="cpu")
    with pytest.raises(NotImplementedError, match="looped kernel"):
        power_map(scene, X, Y, max_order=3, device="cpu")
    with pytest.raises(ValueError, match="power_fun"):
        power_map(scene, X, Y, power_fun=_power, backend="cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        power_map(scene, X, Y, solver="fermat", device="cpu")
    # Requests the JAX package sends to its tracer run on the eager tracer.
    assert float(power_map(scene, X, Y, power_fun=_power, device="cpu").abs().sum()) == 0.0
    z = power_map(scene, X, Y, max_order=2, grad=True, backend="torch", device="cpu")
    assert z.shape == (6, 6, 2)


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_fermat_raises_on_every_backend_with_the_jax_route(backend):
    """Neither route solves Fermat/MPT yet; the error names the roadmap item
    and where the JAX package runs the request."""
    scene = Scene.basic_scene(device="cpu")
    X, Y = scene.grid(4)
    with pytest.raises(NotImplementedError, match="item 9.*solver kernel"):
        power_map(scene, X, Y, solver="fermat", key=0, order=1, backend=backend,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 9.*without a key"):
        power_map(scene, X, Y, solver="mpt", backend=backend, device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        power_map(scene, X, Y, solver="newton", backend=backend, device="cpu")


def test_kernel_caps_match_the_cuda_source():
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "ops", "csrc", "power_map.cu")) as f:
        src = f.read()
    for name, value in (("PM_MAX_ORDER", pmk.MAX_ORDER), ("PM_MAX_WALLS", pmk.MAX_WALLS)):
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
