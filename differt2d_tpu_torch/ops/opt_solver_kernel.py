"""Wrapper of the order-1 Fermat/MPT solver kernel, with its plain version.

One hand-written kernel in ``csrc/opt_solver.cu``, ``opt_solver_value``,
replaces the Pallas kernel
``differt2d_tpu/ops/pallas_solver.py::build_opt_order1_kernel`` (B6): per
pixel and order-1 candidate, an adam solve of the bounce's wall parameter,
then the validity and power of the path.  Its divisions by a shared divisor
go through that divisor's reciprocal, exactly (``div_by`` in the source);
the kernel as it was before that redesign is exported beside it as
``opt_solver_value_seq`` (:func:`twin_value`), its bitwise reference, for
checks only: the dispatch never calls it.  :func:`solver_map` is the route
of ``_opt_solver_map`` (``pallas_kernels.py:3831-3921``): the line-of-sight
group through the unrolled kernel (``power_map_value``, B1), the order-1
group through this one, each candidate's initial parameter drawn from the
request's key as the JAX package draws it.

:func:`plain_opt_value` is the kernel's plain PyTorch version (the eager
solve of :mod:`differt2d_tpu_torch.eager`).  :func:`value` takes it only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.  :data:`LAUNCHES` counts the launches (one per transmitter),
:data:`TWIN_LAUNCHES` the twin's.
:class:`SolverMapFunction` makes the map differentiable: the kernels
compute the forward pass and the eager solve's VJP the backward, as
:class:`~differt2d_tpu_torch.ops.power_map_kernel.PowerMapFunction` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import eager, logic, optimize
from ..defaults import KIND_VERTEX
from . import _build, power_map_kernel
from .power_map_kernel import _check, _host_float, _soft_mode

SOURCE = "opt_solver.cu"
MAX_WALLS = 512
"""Most objects the kernel takes (``OS_MAX_WALLS``, shared memory)."""
OBJECTIVES = {"fermat": 0, "mpt": 1}

LAUNCHES = {"opt_solver_value": 0}
"""Launches of the kernel since the process started (or was reset)."""
TWIN_LAUNCHES = {"opt_solver_value_seq": 0}
"""Launches of the sequential twin (:func:`twin_value`), which only checks
call."""


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_LAUNCHES):
        for name in counts:
            counts[name] = 0


def kernel_caps_reason(num_walls: int, max_order: int) -> Optional[str]:
    """Why the kernel cannot take this many objects or this order, or None."""
    if num_walls > MAX_WALLS:
        return f"the solver kernel holds at most {MAX_WALLS} objects, got {num_walls}"
    if max_order > 1:
        return f"the solver kernel takes orders <= 1, got {max_order}"
    return None


@dataclasses.dataclass(frozen=True)
class SolverInputs:
    """Device inputs of a solver map, derived from the candidate set, the
    key and the scene's kinds.

    ``cand`` (``int32[C]``) holds the wall of each order-1 candidate and
    ``x0`` (``float32[C]``) its initial parameter (both None without
    order-1 candidates); ``bc`` is :func:`optimize.bias_table`; ``los`` the
    unrolled kernel's inputs of the line-of-sight group (None without one).
    ``order1`` is the eager form of the order-1 group alone (the kernel's
    plain version), ``eager`` that of the whole request (the backward).
    """

    objective: str
    steps: int
    cand: Optional[torch.Tensor]
    x0: Optional[torch.Tensor]
    bc: torch.Tensor
    los: Optional[power_map_kernel.KernelInputs]
    order1: eager.EagerSpec
    eager: eager.EagerSpec


def solver_inputs(groups: dict, key, device, *, solver: str, steps: int, approx: bool,
                  sigmoid: bool, kinds: tuple) -> SolverInputs:
    """Cached :class:`SolverInputs` (``power_map_kernel.cached_inputs``,
    keyed on the candidates, the key, the solver, ``steps`` and the kinds).

    Raises where ``_opt_solver_map`` raises: orders above 1, no key, a
    vertex among the order-1 candidates.
    """
    if not set(groups) <= {0, 1}:
        msg = f"the solver kernel takes orders <= 1, got orders {sorted(groups)}"
        raise ValueError(msg)
    if solver not in OBJECTIVES:
        msg = f"the solver kernel solves 'fermat' or 'mpt', got {solver!r}"
        raise ValueError(msg)
    has1 = 1 in groups and groups[1].shape[0] > 0
    if has1 and key is None:
        msg = f"solver {solver!r} requires a PRNG key"
        raise ValueError(msg)
    if has1 and np.any(np.asarray(kinds)[groups[1][:, 0]] == KIND_VERTEX):
        msg = "vertex candidates run on the eager tracer, not the solver kernel"
        raise ValueError(msg)

    def make():
        function = logic._sigmoid if sigmoid else logic._hard_sigmoid
        keys = None if key is None else eager.group_keys(groups, key)

        def spec(sub: dict, sub_keys) -> eager.EagerSpec:
            return eager.EagerSpec(
                groups=eager.make_groups(sub, device), approx=bool(approx), function=function,
                solver=solver, steps=steps, keys=sub_keys, kinds=tuple(kinds),
            )

        order1 = {1: groups[1]} if has1 else {}
        k1 = keys[sorted(groups).index(1)] if has1 else None
        los = {0: groups[0]} if 0 in groups and groups[0].shape[0] else None
        return SolverInputs(
            objective=solver,
            steps=int(steps),
            cand=torch.from_numpy(np.array(groups[1][:, 0], dtype=np.int32)).to(device)
            if has1 else None,
            x0=torch.from_numpy(eager.solver_inits(k1, 1, 1).reshape(-1)).to(device)
            if has1 else None,
            bc=torch.from_numpy(optimize.bias_table(int(steps)).copy()).to(device),
            los=None if los is None else power_map_kernel.kernel_inputs(
                los, device, approx=approx, sigmoid=sigmoid),
            order1=spec(order1, None if k1 is None else (k1,)),
            eager=spec(groups, keys),
        )

    tag = ("solver", solver, int(steps), None if key is None else key.tobytes(), tuple(kinds))
    return power_map_kernel.cached_inputs(tag, groups, device, approx, sigmoid, make)


# -- plain version ------------------------------------------------------------------


def plain_opt_value(px, py, txs, walls, kind, phi, scalars, inputs: SolverInputs):
    """Plain PyTorch version of ``opt_solver_value`` (summed over the
    transmitters): the eager solve of the order-1 group, ``[P]``."""
    pixels = torch.stack([px, py], dim=-1)
    return eager.eager_value(pixels, txs, walls, kind, phi, scalars, inputs.order1)


# -- kernel ---------------------------------------------------------------------------

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("opt_solver_value", "opt_solver_value_seq"):
        getattr(lib, name).argtypes = [
            _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P,
            _F, _F, _F, _F, _F, _I, _P, _P,
        ]
        getattr(lib, name).restype = _I
    lib.opt_solver_occupancy.argtypes = [_I, _I, _I, _I, _P]
    lib.opt_solver_occupancy.restype = _I


def load_library() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/opt_solver.cu`` on first use."""
    return _build.load(SOURCE, _declare)


def value(px, py, txs, walls, kind, phi, scalars, inputs: SolverInputs, *,
          approx: bool, sigmoid: bool) -> torch.Tensor:
    """The order-1 candidates' map ``[P]`` through ``opt_solver_value``
    (CUDA tensors, one launch per transmitter) or its plain version (CPU
    tensors)."""
    if power_map_kernel._device_kind(px, "opt_solver_value") == "cpu":
        return plain_opt_value(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("opt_solver_value", px, py, txs, walls, kind, phi, scalars, inputs,
                   approx, sigmoid, LAUNCHES)


def twin_value(px, py, txs, walls, kind, phi, scalars, inputs: SolverInputs, *,
               approx: bool, sigmoid: bool) -> torch.Tensor:
    """:func:`value` through ``opt_solver_value_seq``, the kernel before the
    redesign, which ``opt_solver_value`` must equal bit for bit (CUDA
    tensors; the plain version on the CPU).  For checks only."""
    if power_map_kernel._device_kind(px, "opt_solver_value_seq") == "cpu":
        return plain_opt_value(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("opt_solver_value_seq", px, py, txs, walls, kind, phi, scalars, inputs,
                   approx, sigmoid, TWIN_LAUNCHES)


def _launch(name, px, py, txs, walls, kind, phi, scalars, inputs: SolverInputs, approx,
            sigmoid, counts) -> torch.Tensor:
    """The map through kernel ``name`` on CUDA tensors, one launch per
    transmitter."""
    out = torch.zeros_like(px)
    if inputs.cand is None or px.numel() == 0:
        return out
    cap = kernel_caps_reason(walls.shape[0], 1)
    if cap is not None:
        raise ValueError(cap)
    sinp, cosp = torch.sin(phi).contiguous(), torch.cos(phi).contiguous()
    for arg, t, dtype in (
        ("px", px, torch.float32), ("py", py, torch.float32),
        ("txs", txs, torch.float32), ("walls", walls, torch.float32),
        ("kind", kind, torch.int32), ("phi", phi, torch.float32),
        ("cand", inputs.cand, torch.int32), ("x0", inputs.x0, torch.float32),
        ("bc", inputs.bc, torch.float32),
    ):
        if t.device != px.device:
            msg = f"{arg} is on {t.device}, expected {px.device}"
            raise ValueError(msg)
        if t.dtype != dtype or not t.is_contiguous():
            msg = f"{arg} must be contiguous {dtype}, got {t.dtype}"
            raise ValueError(msg)
    P = px.numel()
    if py.numel() != P or tuple(txs.shape[1:]) != (2,) or tuple(walls.shape[1:]) != (2, 2):
        msg = "bad shapes: px/py [P], txs [T, 2], walls [W, 2, 2]"
        raise ValueError(msg)
    if P >= 2**31:
        msg = f"the kernel takes P < 2**31 pixels, got {P}"
        raise ValueError(msg)
    host = [_host_float(v) for v in scalars]
    scratch = torch.empty(4 * (inputs.steps + 1), dtype=torch.float32, device=px.device)
    lib = load_library()
    fn = getattr(lib, name)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        for t in range(txs.shape[0]):
            rc = fn(
                OBJECTIVES[inputs.objective], _soft_mode(approx, sigmoid), px.data_ptr(),
                py.data_ptr(), P, txs[t].data_ptr(), walls.data_ptr(), kind.data_ptr(),
                sinp.data_ptr(), cosp.data_ptr(), walls.shape[0], inputs.cand.data_ptr(),
                inputs.x0.data_ptr(), inputs.cand.numel(), inputs.bc.data_ptr(), inputs.steps,
                scratch.data_ptr(), *host, int(t > 0), out.data_ptr(), stream,
            )
            _check(rc, name)
            counts[name] += 1
    return out


def occupancy(objective: str, soft_mode: int, fast: bool, num_walls: int) -> int:
    """Resident blocks of 128 threads per SM of the solver kernel (the
    redesign, or its twin) on the current device."""
    blocks = ctypes.c_int(0)
    _check(load_library().opt_solver_occupancy(OBJECTIVES[objective], soft_mode, int(fast),
                                               num_walls, ctypes.byref(blocks)),
           "opt_solver_occupancy")
    return blocks.value


def full_value(px, py, txs, walls, kind, phi, scalars, inputs: SolverInputs, *,
               approx: bool, sigmoid: bool) -> torch.Tensor:
    """The whole map ``[P]``: the line-of-sight group through
    ``power_map_value`` plus the order-1 group through :func:`value`."""
    out = value(px, py, txs, walls, kind, phi, scalars, inputs, approx=approx, sigmoid=sigmoid)
    if inputs.los is None:
        return out
    los = power_map_kernel.value(px, py, txs, walls, kind, phi, scalars, inputs.los,
                                 approx=approx, sigmoid=sigmoid)
    return los + out


class SolverMapFunction(torch.autograd.Function):
    """Solver map: the kernels' forward, the eager solve's derivatives (VJP
    backward, JVP forward mode)."""

    @staticmethod
    def forward(px, py, txs, walls, phi, scal, kind, host_scalars, inputs, approx, sigmoid):
        return full_value(px, py, txs, walls, kind, phi, host_scalars, inputs,
                          approx=approx, sigmoid=sigmoid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        power_map_kernel.save_inputs(ctx, inputs)

    @staticmethod
    def backward(ctx, g):
        return (*power_map_kernel.eager_backward(ctx, g), None, None, None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        return power_map_kernel.eager_jvp(ctx, tangents)


def solver_request(scene, X, Y, groups: dict, *, solver: str, steps: int, key, approx: bool,
                   sigmoid: bool, on_transmitters: bool, scalars: tuple) -> tuple:
    """The wrappers' positional arguments for a solver map of the ``X``/``Y``
    grid: ``(px, py, txs, walls, kind, phi, scalars, inputs)``, as
    :func:`value`, :func:`full_value` and :func:`plain_opt_value` take them."""
    px, py, txs, walls = power_map_kernel.request_tensors(scene, X, Y, on_transmitters)
    inputs = solver_inputs(groups, key, X.device, solver=solver, steps=steps, approx=approx,
                           sigmoid=sigmoid, kinds=scene.kinds)
    return px, py, txs, walls, scene.kind, scene.phi, scalars, inputs


def solver_map(scene, X, Y, groups: dict, *, approx: bool, sigmoid: bool,
               **request) -> torch.Tensor:
    """Flat value map ``[P]`` of the ``X``/``Y`` grid through the kernels,
    differentiable through :class:`SolverMapFunction` when autograd tracks
    a scene tensor or a scalar; ``request`` as :func:`solver_request`."""
    args = solver_request(scene, X, Y, groups, approx=approx, sigmoid=sigmoid, **request)
    px, py, txs, walls, kind, phi, scalars, inputs = args
    diff = power_map_kernel.tracked_scalars((px, py, txs, walls, phi), scalars)
    if diff is None:
        return full_value(*args, approx=approx, sigmoid=sigmoid)
    scal, host = diff
    return SolverMapFunction.apply(px, py, txs, walls, phi, scal, kind, host, inputs, approx,
                                   sigmoid)
