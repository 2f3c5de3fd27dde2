"""JAX's default PRNG (``threefry2x32``, partitionable layout) in NumPy.

The Fermat and MPT solvers start each candidate's adam solve from a
uniform draw.  The JAX package draws it with ``jax.random``; PyTorch's
generators (Philox, Mersenne Twister) cannot reproduce those draws, so the
port carries JAX's generator itself, and a map of the port equals the JAX
package's for the same key.

Keys are ``uint32[2]`` arrays, the layout of ``jax.random.key_data`` (and of
a raw ``jax.random.PRNGKey``).  :func:`PRNGKey`, :func:`split` and
:func:`uniform` return bit for bit what ``jax.random`` returns under
``jax_threefry_partitionable=True`` (JAX's default):

* the counters of a draw of shape ``s`` are the 64-bit flat indices of
  ``s``, as two 32-bit words (high, low);
* ``split`` keeps both output words of each counter as the new key;
* ``uniform`` takes the XOR of the two words, keeps its 23 high bits as the
  mantissa of a float32 in ``[1, 2)``, subtracts 1 and scales to
  ``[minval, maxval)``.

``split`` and ``uniform`` also take a batch of keys ``uint32[..., 2]`` and
then return what ``jax.vmap`` of them returns.

>>> k = PRNGKey(1234)
>>> k.dtype, k.shape
(dtype('uint32'), (2,))
>>> split(k, 3).shape
(3, 2)
>>> uniform(split(k, 3), (2,)).shape
(3, 2)
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds: the two output words for the counters
    ``(x0, x1)`` (uint32 arrays of one shape ``S``) under ``key``
    (``uint32[..., 2]``), of shape ``key.shape[:-1] + S``."""
    lead = (1,) * x0.ndim
    k0 = key[..., 0].reshape(key.shape[:-1] + lead)
    k1 = key[..., 1].reshape(key.shape[:-1] + lead)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def as_key(key) -> np.ndarray:
    """``key`` (array-like or tensor of non-negative integers below 2**32,
    last axis 2) as ``uint32[..., 2]``."""
    if hasattr(key, "detach"):
        key = key.detach().cpu().numpy()
    arr = np.asarray(key)
    if arr.ndim < 1 or arr.shape[-1] != 2 or not np.issubdtype(arr.dtype, np.integer):
        msg = f"a PRNG key is an integer array of shape (2,), got {arr.dtype}{list(arr.shape)}"
        raise TypeError(msg)
    wide = arr.astype(np.int64)
    if np.any((wide < 0) | (wide >= 2**32)):
        msg = f"a PRNG key's words are uint32, got {arr.tolist()}"
        raise ValueError(msg)
    return wide.astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 -- the name of jax.random.PRNGKey
    """Key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _counters(shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    """High and low words of the flat index of every element of ``shape``."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys of each key: ``uint32[..., num, 2]``."""
    b0, b1 = threefry2x32(as_key(key), *_counters((int(num),)))
    return np.stack([b0, b1], axis=-1)


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 draws in ``[minval, maxval)`` of ``shape`` for each key:
    ``float32[..., *shape]``."""
    b0, b1 = threefry2x32(as_key(key), *_counters(tuple(int(s) for s in shape)))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)
