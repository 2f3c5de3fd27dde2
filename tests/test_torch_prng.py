"""The port's PRNG and adam bias table against JAX, bit for bit.

``differt2d_tpu_torch.prng`` carries JAX's ``threefry2x32`` generator (the
partitionable layout, JAX's default) so that the Fermat/MPT solvers start
from the JAX package's draws; ``differt2d_tpu_torch.optimize.bias_table``
holds the float32 powers ``b**count`` that XLA forms on the CPU.  Both must
equal the installed JAX's values exactly: one ulp moves MPT trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from differt2d_tpu_torch import optimize, prng

SEEDS = (0, 1234, 2**31 + 5)


def test_jax_uses_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("n", [1, 7, 137])
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_draws_equal_jax(seed, n):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    jkeys = jax.random.split(jkey, n)
    keys = prng.split(key, n)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    for shape in ((1,), (2,)):
        jdraws = np.asarray(jax.vmap(lambda k, s=shape: jax.random.uniform(k, s))(jkeys))
        draws = np.stack([prng.uniform(k, shape) for k in keys])
        assert draws.dtype == np.float32
        np.testing.assert_array_equal(draws.view(np.uint32), jdraws.view(np.uint32))
        # A batch of keys draws what jax.vmap draws.
        np.testing.assert_array_equal(prng.uniform(keys, shape), jdraws)


def test_nested_splits_and_ranges_equal_jax():
    jkeys = jax.random.split(jax.random.PRNGKey(7), 5)
    keys = prng.split(prng.PRNGKey(7), 5)
    jdraws = jax.vmap(lambda k: jax.vmap(lambda s: jax.random.uniform(s, (3,)))(
        jax.random.split(k, 4)))(jkeys)
    np.testing.assert_array_equal(prng.uniform(prng.split(keys, 4), (3,)), np.asarray(jdraws))
    # Off [0, 1), XLA:CPU contracts the scale and shift into one FMA: an ulp.
    j = jax.random.uniform(jax.random.PRNGKey(3), (2, 3), minval=-2.0, maxval=5.0)
    np.testing.assert_allclose(prng.uniform(prng.PRNGKey(3), (2, 3), -2.0, 5.0), np.asarray(j),
                               rtol=2e-7, atol=0)


def test_keys_in_other_forms():
    key = prng.PRNGKey(1234)
    np.testing.assert_array_equal(prng.as_key(torch.tensor(key.astype(np.int64))), key)
    np.testing.assert_array_equal(prng.split(np.asarray(jax.random.PRNGKey(1234)), 3),
                                  prng.split(key, 3))
    with pytest.raises(TypeError, match="shape"):
        prng.as_key(np.zeros(3, np.uint32))
    with pytest.raises(TypeError, match="integer"):
        prng.as_key(np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="uint32"):
        prng.as_key([-1, 0])


def test_bias_table_equals_jax():
    """Up to 1000 steps: the solver kernel's table (``jnp.float32(b) **
    counts``, ``pallas_solver.py:264-270``) and optax's ``decay**count``."""
    steps = 1000
    table = optimize.bias_table(steps)
    counts = jnp.arange(1, steps + 1, dtype=jnp.float32)
    ref = np.concatenate([
        np.asarray(jnp.float32(optimize.ADAM_B1) ** counts),
        np.asarray(jnp.float32(optimize.ADAM_B2) ** counts),
    ])
    np.testing.assert_array_equal(table.view(np.uint32), ref.view(np.uint32))
    ints = jnp.arange(1, steps + 1, dtype=jnp.int32)
    for j, b in enumerate((optimize.ADAM_B1, optimize.ADAM_B2)):
        opt = np.asarray(jax.jit(lambda c, b=b: b**c)(ints))
        np.testing.assert_array_equal(table[j * steps : (j + 1) * steps], opt)
    short = optimize.bias_table(50)
    np.testing.assert_array_equal(short[:50], table[:50])
    np.testing.assert_array_equal(short[50:], table[steps : steps + 50])


def test_adam_constants_match_optax():
    """optax.adam(0.1)'s first update from zero moments, on gradients spread
    over ten decades, against minimize's first step.  They agree to float32
    rounding, not bit for bit: XLA:CPU fuses the update, and PyTorch's
    AVX-512 sqrt on the CPU is not correctly rounded."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=64).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 4, 64)
    opt = optax.adam(0.1)
    upd, _ = opt.update(jnp.asarray(g), opt.init(jnp.zeros(64)))
    x, _ = optimize.minimize(lambda x: torch.sum(x * torch.from_numpy(g)), torch.zeros(64),
                             steps=1)
    np.testing.assert_allclose(x.numpy(), np.asarray(upd), rtol=2e-7, atol=0)
