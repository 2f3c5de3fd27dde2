"""The port's paper scripts (``papers/*/*_torch.py``) on the CPU.

Each script runs headless with ``--device cpu`` at the tiny arguments
``tests/test_examples.py`` gives its JAX counterpart, and the arrays its
``main`` returns are held against the JAX package's same requests, on the
same grids: value maps against ``power_map(..., backend="xla")`` at rtol
1e-4 / atol 1e-5, the RIS map as ``tests/test_torch_solver.py`` holds it
(rtol 1e-3 / atol 1e-5), the transmitter trajectories against
``jax.value_and_grad`` with ``optax.chain(adam(0.01), zero_nans())`` at
rtol 1e-4 / atol 1e-5.  No script imports JAX.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.geometry import RIS as JRIS
from differt2d_tpu.geometry import Point as JPoint
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu.utils import P0
from differt2d_tpu.utils import received_power as jreceived_power

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ("eucap2024/plot_zero_gradient_torch", "eucap2024/plot_power_map_torch",
           "eucap2024/plot_optimize_steps_torch", "joss/plot_ris_power_map_torch",
           "joss/plot_optimize_steps_torch")
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
RIS_TOL = dict(rtol=1e-3, atol=1e-5)
TRAJECTORY_TOL = dict(rtol=1e-4, atol=1e-5)


def run(script: str, args: list, tmp_path) -> dict:
    """``main`` of ``papers/<script>.py`` at ``args`` on the CPU, headless."""
    import matplotlib

    matplotlib.use("Agg")
    name = script.replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, REPO_ROOT / "papers" / f"{script}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    output = tmp_path / f"{name}.png"
    try:
        out = module.main([*args, "--output", str(output), "--device", "cpu"])
    finally:
        import matplotlib.pyplot as plt

        plt.close("all")
    assert output.exists()
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def jax_map(scene, X, Y, **kw) -> np.ndarray:
    """The JAX package's map on the port's grid."""
    return np.asarray(jtracer.power_map(scene, jnp.asarray(_np(X)), jnp.asarray(_np(Y)),
                                        backend="xla", **kw))


def jax_trajectory(scene, receivers, approx: bool, steps: int):
    """The original scripts' loop (TX points and the JOSS script's
    ``(alpha, tx)`` snapshots), with each receiver's power from the JAX
    package's array core: ``power_map`` with the transmitter as a one-pixel
    grid (``on_transmitters=True``), whose numerics are those of
    ``accumulate_over_paths`` (the object API jitted takes minutes to
    compile on the CPU)."""

    def loss(tx, alpha):
        acc = jnp.array(jnp.inf)
        for rx in receivers:
            p = jtracer.power_map(scene.with_receivers(rx=JPoint(xy=rx)), tx[0].reshape(1, 1),
                                  tx[1].reshape(1, 1), on_transmitters=True, max_order=1,
                                  approx=approx, alpha=alpha, backend="xla", jit=False)[0, 0]
            acc = jnp.minimum(acc, p / P0)
        return -acc

    f_and_df = jax.jit(jax.value_and_grad(loss))
    optimizer = optax.chain(optax.adam(0.01), optax.zero_nans())
    tx = jnp.array([0.5, 0.7])
    opt_state = optimizer.init(tx)
    traj, taken = [tx], []
    snap_every = max(1, steps // 4)
    for frame, alpha in enumerate(jnp.logspace(0, 2, steps)):
        if frame % snap_every == 0 and len(taken) < 4:
            taken.append((float(alpha), tx))
        _, grads = f_and_df(tx, alpha)
        updates, opt_state = optimizer.update(grads, opt_state)
        tx = tx + updates
        traj.append(tx)
    return np.asarray(jnp.stack(traj)), taken


RECEIVERS = (jnp.array([0.3, 0.1]), jnp.array([0.5, 0.1]))


def _close_grid(out, n: int, jscene) -> None:
    """The port's grid is the JAX package's (to float32 rounding)."""
    jX, jY = jscene.grid(n)
    np.testing.assert_allclose(_np(out["X"]), np.asarray(jX), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(out["Y"]), np.asarray(jY), rtol=0, atol=1e-6)


def test_zero_gradient(tmp_path):
    out = run("eucap2024/plot_zero_gradient_torch", ["--resolution", "16"], tmp_path)
    js = JScene.square_scene_with_wall()
    _close_grid(out, 16, js)
    ref = jax_map(js, out["X"], out["Y"], max_order=0, approx=False)
    np.testing.assert_allclose(_np(out["P"]), ref, **VALUE_TOL)
    assert out["P"].shape == (16, 16) and float(out["P"].max()) > 0.0


def test_eucap_power_map(tmp_path):
    out = run("eucap2024/plot_power_map_torch", ["--resolution", "12"], tmp_path)
    js = JScene.basic_scene()
    _close_grid(out, 12, js)
    for approx in (False, True):
        ref = jax_map(js, out["X"], out["Y"], max_order=1, approx=approx,
                      key=jax.random.PRNGKey(1234))
        np.testing.assert_allclose(_np(out["Z"][approx]), ref, **VALUE_TOL)


def test_eucap_optimize_steps(tmp_path):
    out = run("eucap2024/plot_optimize_steps_torch", ["--steps", "3"], tmp_path)
    js = JScene.square_scene_with_obstacle()
    for approx in (False, True):
        ref, _ = jax_trajectory(js, RECEIVERS, approx, 3)
        traj = _np(out["trajectories"][approx])
        assert traj.shape == (4, 2)
        np.testing.assert_allclose(traj, ref, **TRAJECTORY_TOL)
        assert not np.array_equal(traj[-1], traj[0])


def test_joss_ris_power_map(tmp_path):
    out = run("joss/plot_ris_power_map_torch", ["--resolution", "8"], tmp_path)
    js = JScene.square_scene().add_objects(JRIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]])))
    _close_grid(out, 8, js)
    ref = jax_map(js, out["X"], out["Y"], order=1, solver="mpt", steps=1000, approx=True,
                  key=jax.random.PRNGKey(1234), filter_objects=lambda o: isinstance(o, JRIS))
    np.testing.assert_allclose(_np(out["Z"]), ref, **RIS_TOL)
    assert float(out["Z"].max()) > 0.0


def test_joss_optimize_steps(tmp_path):
    out = run("joss/plot_optimize_steps_torch", ["--steps", "4", "--resolution", "12"], tmp_path)
    js = JScene.square_scene_with_obstacle().with_receivers(
        rx_0=JPoint(xy=RECEIVERS[0]), rx_1=JPoint(xy=RECEIVERS[1]))
    ref, taken = jax_trajectory(js, RECEIVERS, True, 4)
    np.testing.assert_allclose(_np(out["trajectory"]), ref, **TRAJECTORY_TOL)
    assert len(out["snapshots"]) == len(taken) == 4
    for snap, (alpha, tx) in zip(out["snapshots"], taken):
        np.testing.assert_allclose(snap["alpha"], alpha, rtol=1e-6)
        np.testing.assert_allclose(_np(snap["tx"]), np.asarray(tx), **TRAJECTORY_TOL)
        # The JAX map of the port's own snapshot (same TX, alpha and grid).
        s = js.with_transmitters(tx=JPoint(xy=jnp.asarray(_np(snap["tx"]))))
        ref_map = jax_map(s, snap["X"], snap["Y"], max_order=1, approx=True, alpha=snap["alpha"])
        np.testing.assert_allclose(_np(snap["Z"]), ref_map, **VALUE_TOL)


def test_optax_adam_matches_optax():
    """``optimize.OptaxAdam`` is ``optax.chain(adam(0.01), zero_nans())``
    bit for bit, NaN gradients included."""
    from differt2d_tpu_torch.optimize import OptaxAdam

    rng = np.random.default_rng(0)
    grads = rng.normal(size=(40, 3)).astype(np.float32)
    grads[7, 1] = grads[20, 0] = np.nan
    opt, optimizer = OptaxAdam(0.01, 40), optax.chain(optax.adam(0.01), optax.zero_nans())
    x, jx = torch.zeros(3), jnp.zeros(3)
    state = optimizer.init(jx)
    for g in grads:
        x = opt.step(x, torch.from_numpy(g))
        with jax.debug_nans(False):  # the suite turns NaN checks on
            updates, state = optimizer.update(jnp.asarray(g), state)
            jx = jx + updates
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    with pytest.raises(ValueError, match="40 steps"):
        opt.step(x, torch.zeros(3))


def test_papers_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"for name in {list(SCRIPTS)!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name.replace('/', '_'),"
        f" {str(REPO_ROOT / 'papers')!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'differt2d_tpu' or m.startswith('differt2d_tpu.'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert sorted(p.relative_to(REPO_ROOT / "papers").with_suffix("").as_posix()
                  for p in (REPO_ROOT / "papers").glob("*/*_torch.py")) == sorted(SCRIPTS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
