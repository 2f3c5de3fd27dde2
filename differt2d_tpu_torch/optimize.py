"""Inner optimizer of the Fermat and Min-Path-Tracing solvers.

Counterpart of :mod:`differt2d_tpu.optimize`: :func:`minimize` runs a fixed
number of adam steps with optax's arithmetic (``optax.adam(0.1)``: b1 0.9,
b2 0.999, eps 1e-8, eps_root 0, updates added to ``x``), written out by
hand -- ``torch.optim.Adam`` places eps and the bias correction
differently.  The loop is unrolled under autograd, so gradients flow
through the argmin, as they do through the JAX package's ``lax.scan``.

Each step's derivative is ``torch.autograd.grad``'s, except where the
inputs are seen by a ``torch.func`` transform (``vmap``, ``grad``,
``jvp``) or carry forward-mode tangents: there ``requires_grad_`` cannot
be set, and the step takes ``torch.func.grad_and_value`` instead, which
computes the same operations (the same bits) at more host cost per step.
So the solve runs inside ``torch.func.jvp`` (forward mode, as
:func:`value_and_grad_fwd` drives it) and ``vmap``.

``minimize(implicit=True)`` keeps the forward solve and differentiates it
by the implicit-function theorem at the solution (:class:`_ImplicitSolve`).

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
import dataclasses
import functools
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor

from . import prng
from ._tree import tree_flatten, tree_map, tree_unflatten
from .defaults import DEFAULT_DEVICE, resolve_device


ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
ADAM_EPS_ROOT = 0.0
ADAM_LR = 0.1

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


def transformed(*trees) -> bool:
    """Whether a tensor of ``trees`` is seen by a ``torch.func`` transform
    or carries a forward-mode tangent of ``torch.autograd.forward_ad``."""
    for tree in trees:
        for t in tree_flatten(tree)[0]:
            if is_functorch_wrapped_tensor(t) or fwAD.unpack_dual(t).tangent is not None:
                return True
    return False


@functools.lru_cache(maxsize=None)
def _load_forward_ad() -> None:
    """Load PyTorch's forward-mode decompositions, which its first dual
    tensor loads, without the ``torch.jit.script`` deprecation warning that
    their loader emits on recent PyTorch versions."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        with fwAD.dual_level():
            fwAD.make_dual(torch.zeros(()), torch.zeros(()))


def jvp(fn: Callable, primals: tuple, tangents: tuple):
    """``torch.func.jvp(fn, primals, tangents)``, the forward mode every part
    of the port uses (PyTorch's decompositions loaded quietly first)."""
    _load_forward_ad()
    return torch.func.jvp(fn, primals, tangents)


def constants(tree):
    """``tree`` with its tensors stripped of ``torch.func`` wrappers.

    Inside a ``jvp`` or ``grad`` transform every tensor created, even from
    NumPy, comes out wrapped (a zero tangent); such a tensor cannot be read
    on the host, handed to a kernel or kept past the transform.  For what
    is built from host data (candidate rows, keys' draws, culling tables,
    the kernels' cached inputs) this gives the plain tensors."""

    def plain(t):
        while is_functorch_wrapped_tensor(t):
            t = get_unwrapped(t)
        return t

    if not any(is_functorch_wrapped_tensor(t) for t in tree_flatten(tree)[0]):
        return tree
    return tree_map(plain, tree)


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

    ``fun`` may return a batch of independent objectives, one per index of
    ``x``'s leading axes (``x[..., n]``, ``fun`` of shape ``x.shape[:-1]``):
    the derivative taken is that of their sum, which is each one's own.
    ``args`` may nest tuples, lists, dicts and geometry objects.

    By default the solve is differentiable in ``x0`` and in the tensors of
    ``args``, by autograd (the unrolled iterations are recorded when grad
    mode is on and one of them requires a gradient; otherwise each step's
    derivative is taken and dropped) and by ``torch.func`` transforms.

    ``implicit=True`` runs the same solve and differentiates it by the
    implicit-function theorem at the solution instead (as
    ``differt2d_tpu.optimize._minimize_implicit``): per objective, an
    ``n x n`` Hessian ``H`` with the ridge ``1e-6 (tr H / n + 1)``, one
    linear solve and one vector-Jacobian product of ``df/dx`` in ``args``;
    the loss output adds its envelope term (``df/dx . dx + df/dargs``).
    Exact at a converged stationary point, O(1) memory in ``steps``.
    Differentiable data must then ride in ``args`` (what ``fun`` closes
    over gets no gradient), and ``x0`` gets none: the solution depends on
    it only through the basin it selects.

    >>> x, y = minimize(lambda x: torch.sum((x - 1.0) ** 2), torch.zeros(3))
    >>> bool(torch.allclose(x, torch.ones(3), rtol=1e-2)), bool(y < 1e-3)
    (True, True)
    """
    steps = int(steps)
    if steps < 1:
        msg = f"steps must be >= 1, got {steps}"
        raise ValueError(msg)
    if implicit:
        leaves, spec = tree_flatten(tuple(args))
        return _ImplicitSolve.apply(x0, _Problem(fun, spec, steps), *leaves)
    return _minimize(fun, x0, tuple(args), steps)


def _minimize(fun, x0, args: tuple, steps: int):
    functional = transformed(x0, args)
    track = (
        not functional
        and torch.is_grad_enabled()
        and any(t.requires_grad for t in tree_flatten((x0, args))[0])
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
        if functional:
            g, loss = _func_step(fun, x, args)
            xi = x
        else:
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
        x = (xi if track or functional else x) + (-ADAM_LR) * update
    return x, loss


def _func_step(fun, x, args):
    """``(d sum(fun) / dx, fun)`` at ``x`` by ``torch.func``."""

    def total(x_):
        loss = fun(x_, *args)
        return loss.sum(), loss

    g, (_, loss) = torch.func.grad_and_value(total, has_aux=True)(x)
    return g, loss


# -- implicit differentiation ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Problem:
    """The static part of an implicit solve: ``fun``, the structure of its
    ``args`` and the number of steps."""

    fun: Callable
    spec: Any
    steps: int

    def objective(self, x, leaves):
        return self.fun(x, *tree_unflatten(self.spec, leaves))

    def grad_x(self, x, leaves):
        """Per objective, ``df/dx`` (``[..., n]``)."""
        return torch.func.grad(lambda x_: self.objective(x_, leaves).sum())(x)

    def system(self, x, leaves):
        """Per objective, ``H + ridge I`` (``[..., n, n]``, ``H[..., i, k] =
        d(df/dx_i)/dx_k``), the ridge ``1e-6 (tr H / n + 1)``."""
        n = x.shape[-1]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        cols = [
            jvp(lambda x_: self.grad_x(x_, leaves), (x,), (torch.zeros_like(x) + eye[k],))[1]
            for k in range(n)
        ]
        H = torch.stack(cols, dim=-1)
        ridge = 1e-6 * (torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / max(n, 1) + 1.0)
        return H + ridge[..., None, None] * eye


def _with(leaves, idx, values) -> list:
    out = list(leaves)
    for i, v in zip(idx, values):
        out[i] = v
    return out


def _solve_system(A, b):
    """``A^-1 b`` per objective (``b[..., n]``); nothing for ``n == 0``."""
    if b.shape[-1] == 0:
        return torch.zeros_like(b)
    return torch.linalg.solve(A, b.unsqueeze(-1)).squeeze(-1)


class _ImplicitSolve(torch.autograd.Function):
    """``(x*, last_loss) = minimize(fun, x0, args)`` with implicit-function
    derivatives: the tangent of ``g(x*, p) = df/dx = 0`` gives ``dx* =
    -(H + ridge I)^-1 (dg/dp) dp``, and the loss's tangent is that of
    ``f(x*, p)`` along ``(dx*, dp)``.  ``jvp`` is that rule, ``backward``
    its transpose; neither gives ``x0`` a derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x0, problem, *leaves):
        return _minimize(problem.fun, x0, tree_unflatten(problem.spec, leaves), problem.steps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, problem, *leaves = inputs
        ctx.problem = problem
        ctx.save_for_backward(output[0], *leaves)
        ctx.save_for_forward(output[0], *leaves)

    @staticmethod
    def jvp(ctx, _tx0, _tproblem, *tleaves):
        x, *leaves = ctx.saved_tensors
        p = ctx.problem
        idx = [i for i, (leaf, t) in enumerate(zip(leaves, tleaves))
               if t is not None and leaf.is_floating_point()]
        if not idx:
            return torch.zeros_like(x), torch.zeros_like(x[..., 0])
        primals = tuple(leaves[i] for i in idx)
        tangents = tuple(tleaves[i] for i in idx)
        _, gdot = jvp(lambda *d: p.grad_x(x, _with(leaves, idx, d)), primals, tangents)
        dx = -_solve_system(p.system(x, leaves), gdot.to(x.dtype))
        loss, dloss = jvp(lambda x_, *d: p.objective(x_, _with(leaves, idx, d)),
                          (x, *primals), (dx, *tangents))
        return dx, dloss.to(loss.dtype)

    @staticmethod
    def backward(ctx, gx, gloss):
        x, *leaves = ctx.saved_tensors
        p = ctx.problem
        idx = [i for i, leaf in enumerate(leaves) if leaf.is_floating_point()]
        u = gx + gloss[..., None] * p.grad_x(x, leaves)
        w = -_solve_system(p.system(x, leaves).mT, u)
        _, pull = torch.func.vjp(
            lambda *d: (p.grad_x(x, _with(leaves, idx, d)), p.objective(x, _with(leaves, idx, d))),
            *(leaves[i] for i in idx),
        )
        grads = [None] * len(leaves)
        for i, g in zip(idx, pull((w, gloss))):
            grads[i] = g
        return (None, None, *grads)


def value_and_grad_fwd(fun: Callable[..., torch.Tensor]) -> Callable[..., tuple]:
    """``(value, grad)`` of the scalar ``fun(x, *args)`` with respect to
    ``x``, in forward mode (``differt2d_tpu.optimize.value_and_grad_fwd``).

    One ``torch.func.jvp`` pass per scalar of ``x``, along its basis
    tangent: for objectives that differentiate through the solvers'
    unrolled adam loop with few free parameters (a RIS phase, a transmitter
    position), each pass streams the loop once without storing it.  The
    derivative is that of reverse mode, up to float rounding.

    >>> v, g = value_and_grad_fwd(lambda x: torch.sum(x**2))(torch.tensor([1.0, 2.0]))
    >>> float(v), g.tolist()
    (5.0, [2.0, 4.0])
    """

    def wrapped(x, *args):
        x = torch.as_tensor(x)
        flat = x.reshape(-1)
        basis = torch.eye(flat.numel(), dtype=flat.dtype, device=flat.device)
        value, tangents = None, []
        for tangent in basis:
            value, dv = jvp(lambda f: fun(f.reshape(x.shape), *args), (flat,), (tangent,))
            # Some of PyTorch's forward-mode rules promote a Python scalar
            # operand (r_coef**n / ...) to float64 in the tangent alone.
            tangents.append(dv.to(value.dtype))
        return value, torch.stack(tangents).reshape(x.shape)

    return wrapped


def minimize_random_uniform(fun: Callable[..., torch.Tensor], key, n: int, *,
                            device=DEFAULT_DEVICE, **kwargs: Any):
    """:func:`minimize` from ``x0 = prng.uniform(key, (n,))`` (JAX's draw,
    bit for bit) on ``device``."""
    x0 = torch.from_numpy(prng.uniform(key, (int(n),))).to(resolve_device(device))
    return minimize(fun, x0, **kwargs)


def minimize_many_random_uniform(fun: Callable[..., torch.Tensor], key, n: int,
                                 many: int = 10, *, device=DEFAULT_DEVICE, **kwargs: Any):
    """The best (least last loss, the first on ties) of ``many``
    :func:`minimize_random_uniform` restarts, one per key of
    ``prng.split(key, many)``; ``many == 1`` draws from ``key`` itself, as
    the JAX package does."""
    if many == 1:
        return minimize_random_uniform(fun, key, n, device=device, **kwargs)
    runs = [minimize_random_uniform(fun, k, n, device=device, **kwargs)
            for k in prng.split(key, many)]
    xs = torch.stack([x for x, _ in runs])
    losses = torch.stack([loss for _, loss in runs])
    i_min = torch.argmin(losses)
    return xs[i_min], losses[i_min]
