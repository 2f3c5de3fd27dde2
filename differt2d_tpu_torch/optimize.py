"""Inner optimizer of the Fermat and Min-Path-Tracing solvers.

Counterpart of :mod:`differt2d_tpu.optimize`: :func:`minimize` runs a fixed
number of adam steps with optax's arithmetic (``optax.adam(0.1)``: b1 0.9,
b2 0.999, eps 1e-8, eps_root 0, updates added to ``x``), written out by
hand -- ``torch.optim.Adam`` places eps and the bias correction
differently.  The loop is unrolled under autograd, so gradients flow
through the argmin, as they do through the JAX package's ``lax.scan``.

The bias corrections ``1 - b**count`` come from :func:`bias_table`, whose
float32 powers equal those of XLA on the CPU (``jnp.float32(b) ** counts``,
the table of ``pallas_solver.py:264-270``, and optax's ``decay**count``):
XLA lowers that power to the C library's ``powf`` and flushes subnormal
results to zero, and so does :func:`bias_table`.  An ulp of difference
there moves MPT trajectories between basins over a thousand steps.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Callable

import numpy as np
import torch


ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
ADAM_EPS_ROOT = 0.0
ADAM_LR = 0.1

_NOT_PORTED = (
    "{} is not ported yet (ROADMAP §1 item 9b: the cfg3/cfg5 gradient modes);"
    " the unrolled solve (implicit=False) is"
)


@functools.lru_cache(maxsize=None)
def _powf() -> Callable[[float, float], float]:
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


@functools.lru_cache(maxsize=64)
def bias_table(steps: int) -> np.ndarray:
    """``float32[2 * steps]``: ``b1**count`` then ``b2**count`` for the
    1-based step counts, in float32 as XLA on the CPU forms them."""
    powf = _powf()
    tiny = np.finfo(np.float32).tiny
    out = np.empty(2 * steps, dtype=np.float32)
    for j, b in enumerate((ADAM_B1, ADAM_B2)):
        base = float(np.float32(b))
        for t in range(steps):
            v = powf(base, float(t + 1))
            out[j * steps + t] = 0.0 if abs(v) < tiny else v
    out.flags.writeable = False
    return out


def minimize(
    fun: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    args: tuple = (),
    steps: int = 100,
    implicit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimize ``fun(x, *args)`` with ``steps`` adam steps from ``x0``.

    Returns ``(x, last_loss)``: the final iterate and the objective at the
    second-to-last iterate (the reference scan's ``losses[-1]``).

    ``fun`` may return a batch of independent objectives (one per element
    of a batch axis of ``x``): the derivative taken is that of their sum,
    which is each one's own.  The solve is differentiable by the caller's
    autograd in ``x0`` and in the tensors of ``args`` (the unrolled
    iterations are recorded when grad mode is on and one of them requires
    a gradient); otherwise each step's derivative is taken and dropped.

    >>> x, y = minimize(lambda x: torch.sum((x - 1.0) ** 2), torch.zeros(3))
    >>> bool(torch.allclose(x, torch.ones(3), rtol=1e-2)), bool(y < 1e-3)
    (True, True)
    """
    if implicit:
        raise NotImplementedError(_NOT_PORTED.format("minimize(implicit=True)"))
    steps = int(steps)
    if steps < 1:
        msg = f"steps must be >= 1, got {steps}"
        raise ValueError(msg)
    track = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (x0, *args)
    )
    # 1 - b**count in float32, as optax forms it.  A tensor, not host
    # floats: PyTorch's CUDA division by a host scalar multiplies by its
    # reciprocal, which is not IEEE division.
    one_minus = torch.from_numpy(np.float32(1.0) - bias_table(steps)).to(x0.device)
    x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    loss = None
    for t in range(steps):
        with torch.enable_grad():
            xi = x if x.requires_grad else x.detach().requires_grad_(True)
            loss = fun(xi, *args)
            (g,) = torch.autograd.grad(
                loss.sum(), xi, create_graph=track, materialize_grads=True
            )
        if not track:
            loss, g = loss.detach(), g.detach()
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v
        m_hat = m / one_minus[t]
        v_hat = v / one_minus[steps + t]
        update = m_hat / (torch.sqrt(v_hat + ADAM_EPS_ROOT) + ADAM_EPS)
        x = (xi if track else x) + (-ADAM_LR) * update
    return x, loss


def value_and_grad_fwd(fun):
    """Not ported yet: raises :class:`NotImplementedError`."""
    raise NotImplementedError(_NOT_PORTED.format("value_and_grad_fwd"))
