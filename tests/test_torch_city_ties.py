"""The pixels where the JAX package's jitted maps resolve near-ties.

On the 16 x 16 grid of ``linspace(0.05, 0.95)``, six pixels of
``city_scene`` next to the transmitter's street crossing carry near-ties of
the soft max that XLA:CPU's jitted tracer (FMA contraction) resolves
otherwise than its op-by-op run: the jitted gradient differs there far
beyond the kink tolerance.  The port's map equals the op-by-op run at
those pixels, which is why ``test_torch_looped.test_city_maps_match_jax``
may compare on a 0.03-0.97 grid clear of them.  Likewise two pixels of the
basic scene's order-3 map (``test_torch_order2.py``'s comparison uses a grid
clear of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from differt2d_tpu import tracer as jtracer
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu_torch import power_map
from differt2d_tpu_torch.scene import Scene

torch.set_num_threads(1)

PIXELS = ((7, 2), (7, 12), (7, 13), (8, 2), (8, 3), (8, 13))
"""``(row, column)`` of each pixel on the 0.05-0.95 grid."""


def test_city_scene_near_ties_match_the_op_by_op_jax_run():
    x = np.linspace(0.05, 0.95, 16, dtype=np.float32)
    X, Y = np.meshgrid(x, x)
    rows, cols = (list(i) for i in zip(*PIXELS))
    px, py = X[rows, cols][None], Y[rows, cols][None]
    kw = dict(max_order=1, approx=True)
    # Op by op, the tracer's guarded divisions form NaNs that a `where`
    # then drops: the suite's NaN check would stop at the first.
    with jax.debug_nans(False), jax.disable_jit():
        rv, rg = jtracer.power_map(JScene.city_scene(), jnp.asarray(px), jnp.asarray(py),
                                   backend="xla", value_and_grad=True, **kw)
    zv, zg = power_map(Scene.city_scene(device="cpu"), torch.from_numpy(px),
                       torch.from_numpy(py), device="cpu", value_and_grad=True, **kw)
    np.testing.assert_allclose(zv.numpy(), np.asarray(rv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(zg.numpy(), np.asarray(rg), rtol=1e-4, atol=1e-5)
    assert float(zg.abs().min()) > 1.0


BASIC_ORDER3_PIXELS = ((0, 0), (4, 13))
"""``(row, column)`` of the pixels of the basic scene's order-3 map on the
16 x 9 grid of ``linspace(0.05, 0.95)`` by ``linspace(0.07, 0.93)`` where
the jitted XLA:CPU map leaves the tolerances (a near-tie of the order-3
group's soft max); ``test_torch_order2`` uses a grid clear of them."""


def test_basic_scene_order3_near_ties_match_the_op_by_op_jax_run():
    X, Y = np.meshgrid(np.linspace(0.05, 0.95, 16, dtype=np.float32),
                       np.linspace(0.07, 0.93, 9, dtype=np.float32))
    rows, cols = (list(i) for i in zip(*BASIC_ORDER3_PIXELS))
    px, py = X[rows, cols][None], Y[rows, cols][None]
    jx, jy = jnp.asarray(px), jnp.asarray(py)
    tx, ty = torch.from_numpy(px), torch.from_numpy(py)
    scene, jscene = Scene.basic_scene(device="cpu"), JScene.basic_scene()

    def port(**kw):
        return power_map(scene, tx, ty, device="cpu", approx=True, **kw)

    # The near-tie is in the order-3 group: there the op-by-op run is the
    # reference (the jitted map differs); orders 0-2 agree with the jitted
    # map, and the whole order-3 map is their sum.
    top = dict(min_order=3, max_order=3)
    with jax.debug_nans(False), jax.disable_jit():
        rv, rg = jtracer.power_map(jscene, jx, jy, backend="xla", value_and_grad=True,
                                   approx=True, **top)
    zv, zg = port(value_and_grad=True, **top)
    np.testing.assert_allclose(zv.numpy(), np.asarray(rv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(zg.numpy(), np.asarray(rg), rtol=1e-4, atol=1e-5)
    lv, lg = jtracer.power_map(jscene, jx, jy, backend="xla", value_and_grad=True,
                               approx=True, max_order=2)
    yv, yg = port(value_and_grad=True, max_order=2)
    np.testing.assert_allclose(yv.numpy(), np.asarray(lv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yg.numpy(), np.asarray(lg), rtol=1e-4, atol=1e-5)
    fv, fg = port(value_and_grad=True, max_order=3)
    np.testing.assert_allclose(fv.numpy(), (yv + zv).numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fg.numpy(), (yg + zg).numpy(), rtol=1e-6, atol=1e-7)
    # The jitted map is the one that differs there.
    jv = jtracer.power_map(jscene, jx, jy, backend="xla", approx=True, **top)
    assert not np.allclose(np.asarray(jv), zv.numpy(), rtol=1e-4, atol=1e-5)
