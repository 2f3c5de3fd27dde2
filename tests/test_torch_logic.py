"""The port's soft logic against :mod:`differt2d_tpu.logic`, elementwise.

Inputs come from a NumPy seed; the same float32 arrays go to the JAX
function and to its port.  Values match to float32 rounding (rtol 1e-6),
including both saturation ends; derivatives of the activations and of the
soft min/max match JAX's at the kinks (zero slope at the ends of the
hard_sigmoid band, 0.5/0.5 split at exact ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt2d_tpu.logic as jlogic
import differt2d_tpu_torch.logic as tlogic

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
ALPHAS = [1e-3, 1.0, 100.0]
NAMES = ["hard_sigmoid", "sigmoid"]


def _data(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    # Both float32 saturation ends and 0.  (Points where alpha * x lands
    # within an ulp of the hard_sigmoid band edge are left out: there XLA's
    # jit contracts alpha * x + 3 into one FMA and rounds differently from
    # its own eager evaluation; test_hard_sigmoid_zero_slope_at_band_ends
    # covers the edge itself.)
    edges = np.array([-1e30, -100.0, 0.0, 100.0, 1e30], np.float32)
    return np.concatenate([x, edges])


def _close(t, j, **tol):
    np.testing.assert_allclose(
        np.asarray(t.detach().numpy(), dtype=np.float64),
        np.asarray(j, dtype=np.float64),
        **(tol or TOL),
    )


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_activation_values_and_slopes(name, alpha):
    x = _data()
    jf, tf = getattr(jlogic, name), getattr(tlogic, name)
    _close(tlogic.activation(torch.from_numpy(x), alpha, tf),
           jlogic.activation(jnp.asarray(x), alpha, jf))
    xt = torch.from_numpy(x).requires_grad_(True)
    tf(xt, alpha).sum().backward()
    jg = jax.grad(lambda v: jf(v, alpha).sum())(jnp.asarray(x))
    _close(xt.grad, jg, rtol=1e-5, atol=1e-7)


def test_hard_sigmoid_zero_slope_at_band_ends():
    z = torch.tensor([-3.0, 3.0], requires_grad=True)
    tlogic.hard_sigmoid(z, 1.0).sum().backward()
    assert z.grad.tolist() == [0.0, 0.0]
    jg = jax.grad(lambda v: jlogic.hard_sigmoid(v, 1.0).sum())(jnp.array([-3.0, 3.0]))
    assert np.asarray(jg).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("approx", [True, False])
def test_logical_ops_match(approx):
    x = np.clip(_data(1), 0.0, 1.0)
    y = np.clip(_data(2), 0.0, 1.0)
    if not approx:
        x, y = x > 0.5, y > 0.5
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    for op in ("logical_or", "logical_and"):
        _close(getattr(tlogic, op)(tx, ty, approx=approx),
               getattr(jlogic, op)(jx, jy, approx=approx))
    _close(tlogic.logical_not(tx, approx=approx), jlogic.logical_not(jx, approx=approx))
    _close(tlogic.logical_all(tx, ty, axis=0, approx=approx),
           jlogic.logical_all(jx, jy, axis=0, approx=approx))
    _close(tlogic.logical_any(tx, ty, approx=approx),
           jlogic.logical_any(jx, jy, approx=approx))
    _close(tlogic.is_true(tx, approx=approx), jlogic.is_true(jx, approx=approx))
    _close(tlogic.is_false(tx, approx=approx), jlogic.is_false(jx, approx=approx))
    _close(tlogic.true_value(approx), jlogic.true_value(approx))
    _close(tlogic.false_value(approx), jlogic.false_value(approx))


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_comparisons_match(approx, name):
    x, y = _data(3), _data(4)
    kw = dict(alpha=10.0, function=getattr(tlogic, name)) if approx else {}
    jkw = dict(alpha=10.0, function=getattr(jlogic, name)) if approx else {}
    for op in ("greater", "greater_equal", "less", "less_equal"):
        _close(getattr(tlogic, op)(torch.from_numpy(x), torch.from_numpy(y), approx=approx, **kw),
               getattr(jlogic, op)(jnp.asarray(x), jnp.asarray(y), approx=approx, **jkw))


def test_min_max_split_ties_like_jax():
    a = np.array([1.0, 2.0, 0.5], np.float32)
    b = np.array([1.0, 3.0, 0.5], np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (tlogic.logical_and(ta, tb, approx=True) + 2 * tlogic.logical_or(ta, tb, approx=True)).sum().backward()
    ja, jb = jax.grad(
        lambda u, v: (jlogic.logical_and(u, v, approx=True)
                      + 2 * jlogic.logical_or(u, v, approx=True)).sum(),
        argnums=(0, 1),
    )(jnp.asarray(a), jnp.asarray(b))
    _close(ta.grad, ja)
    _close(tb.grad, jb)


def test_approx_tristate_and_context_managers():
    x = torch.tensor([0.2, 0.9])
    y = torch.tensor([0.7, 0.1])
    state = tlogic.ENABLE_APPROX
    try:
        tlogic.set_approx(True)
        assert tlogic.logical_or(x, y).dtype == torch.float32
        with tlogic.disable_approx():
            assert tlogic.ENABLE_APPROX is False
            assert tlogic.logical_or(x > 0.5, y > 0.5).dtype == torch.bool
            with tlogic.enable_approx():
                assert tlogic.ENABLE_APPROX is True
            assert tlogic.ENABLE_APPROX is False
        assert tlogic.ENABLE_APPROX is True
    finally:
        tlogic.set_approx(state)
    assert tlogic.ENABLE_APPROX == state
