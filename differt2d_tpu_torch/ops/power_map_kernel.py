"""Wrappers of the power-map CUDA kernels, with their plain versions.

Two hand-written kernels in ``csrc/power_map.cu`` replace the unrolled
Pallas kernel ``differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel``:

* ``power_map_value`` -- its ``mode="value"``: the map ``[P]``;
* ``power_map_vag`` -- its ``mode="value_and_grad"``: the map and its
  pixel gradient ``([P], [P, 2])``.

Beside each is its plain PyTorch version (:func:`plain_value`,
:func:`plain_value_and_grad`: the eager tracer of
:mod:`differt2d_tpu_torch.eager` on the same inputs).  A wrapper takes the
plain version only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  :data:`LAUNCHES` counts the launches of
each kernel.

:class:`PowerMapFunction` makes the value kernel differentiable, as
``_differentiable_run`` does for the Pallas kernel: the kernel computes the
forward pass, and the backward pass recomputes the plain version under
autograd, for pixels, transmitters, walls, RIS phases and the five
scalars.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import eager, logic
from . import _build

SOURCE = "power_map.cu"
MAX_ORDER = 4
"""Highest candidate order the kernels take (``PM_MAX_ORDER`` in the source;
the candidate rows are ``MAX_ORDER + 1`` wide)."""
MAX_WALLS = 512
"""Most objects the kernels take (``PM_MAX_WALLS``, shared memory)."""

SOFT_NONE, SOFT_HARD, SOFT_SIGMOID = 0, 1, 2

LAUNCHES = {"power_map_value": 0, "power_map_vag": 0}
"""Launches of each kernel since the process started (or was reset)."""

_INPUTS_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_INPUTS_CACHE_MAX = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_caps_reason(num_walls: int, max_order: int) -> Optional[str]:
    """Why the kernels cannot take this many objects or this candidate
    order, or None.  The one place the caps are checked before a launch."""
    if num_walls > MAX_WALLS:
        return f"the CUDA kernels hold at most {MAX_WALLS} objects, got {num_walls}"
    if max_order > MAX_ORDER:
        return f"the CUDA kernels take orders <= {MAX_ORDER}, got {max_order}"
    return None


@dataclasses.dataclass(frozen=True)
class KernelInputs:
    """Device inputs derived from a scene's structure and candidate set.

    ``cand`` is ``int32[C, MAX_ORDER + 1]``: per candidate its order, then
    its object indices, candidates sorted by order (``None`` when
    ``max_order`` exceeds :data:`MAX_ORDER`: the kernels cannot take the
    set).  ``eager`` is the same set in the eager tracer's form, for the
    plain versions.
    """

    cand: Optional[torch.Tensor]
    num_candidates: int
    max_order: int
    eager: eager.EagerSpec


def cached_inputs(kind: str, groups: dict, device, approx: bool, sigmoid: bool, make):
    """``make()`` cached under ``kind`` and the content of its inputs (the
    candidate rows, the logic mode, the device), not their identity, so two
    scenes of the same structure share an entry.  A bounded LRU, shared by
    the unrolled and the looped kernels' inputs."""
    key = (
        kind,
        tuple((o, g.shape, g.tobytes()) for o, g in sorted(groups.items())),
        bool(approx),
        bool(sigmoid),
        str(device),
    )
    hit = _INPUTS_CACHE.get(key)
    if hit is not None:
        _INPUTS_CACHE.move_to_end(key)
        return hit
    entry = make()
    _INPUTS_CACHE[key] = entry
    while len(_INPUTS_CACHE) > _INPUTS_CACHE_MAX:
        _INPUTS_CACHE.popitem(last=False)
    return entry


def kernel_inputs(groups: dict, device, *, approx: bool, sigmoid: bool) -> KernelInputs:
    """Cached :class:`KernelInputs` (:func:`cached_inputs`).

    Wall coordinates, kinds and RIS phases are not in the key: the kernels
    read them from the scene's tensors at every launch, so they can never
    be stale.
    """

    def make():
        table = np.zeros((sum(g.shape[0] for g in groups.values()), MAX_ORDER + 1), np.int32)
        start = 0
        for o, g in sorted(groups.items()):
            if o <= MAX_ORDER:
                table[start : start + g.shape[0], 0] = o
                table[start : start + g.shape[0], 1 : o + 1] = g
            start += g.shape[0]
        max_order = max((o for o, g in groups.items() if g.shape[0]), default=0)
        return KernelInputs(
            cand=torch.from_numpy(table).to(device) if max_order <= MAX_ORDER else None,
            num_candidates=int(table.shape[0]),
            max_order=max_order,
            eager=eager.EagerSpec(
                groups=eager.make_groups(groups, device),
                approx=bool(approx),
                function=logic.sigmoid if sigmoid else logic.hard_sigmoid,
            ),
        )

    return cached_inputs("unrolled", groups, device, approx, sigmoid, make)


# -- plain versions -------------------------------------------------------------


def plain_value(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs):
    """Plain PyTorch version of ``power_map_value``: ``[P]``."""
    pixels = torch.stack([px, py], dim=-1)
    return eager.eager_value(pixels, txs, walls, kind, phi, scalars, inputs.eager)


def plain_value_and_grad(px, py, txs, walls, kind, phi, scalars,
                         inputs: KernelInputs):
    """Plain PyTorch version of ``power_map_vag``: ``([P], [P, 2])``."""
    pixels = torch.stack([px, py], dim=-1)
    return eager.eager_value_and_grad(
        pixels, txs, walls, kind, phi, scalars, inputs.eager
    )


# -- kernels ------------------------------------------------------------------------

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _declare(lib: ctypes.CDLL) -> None:
    common = [_I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _F, _F, _F, _F, _F]
    lib.power_map_value.argtypes = [*common, _P, _P]
    lib.power_map_value.restype = _I
    lib.power_map_vag.argtypes = [*common, _P, _P, _P]
    lib.power_map_vag.restype = _I


def load_library() -> ctypes.CDLL:
    """The kernels' library, built from ``csrc/power_map.cu`` on first use."""
    return _build.load(SOURCE, _declare)


def _host_float(v) -> float:
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def _soft_mode(approx: bool, sigmoid: bool) -> int:
    if not approx:
        return SOFT_NONE
    return SOFT_SIGMOID if sigmoid else SOFT_HARD


def _launch_args(px, py, txs, walls, kind, phi, scalars, inputs, approx, sigmoid):
    cap = kernel_caps_reason(walls.shape[0], inputs.max_order)
    if cap is not None:
        raise ValueError(cap)
    dev = px.device
    for name, t, dtype in (
        ("px", px, torch.float32), ("py", py, torch.float32),
        ("txs", txs, torch.float32), ("walls", walls, torch.float32),
        ("kind", kind, torch.int32), ("phi", phi, torch.float32),
        ("cand", inputs.cand, torch.int32),
    ):
        if t.device != dev:
            msg = f"{name} is on {t.device}, expected {dev}"
            raise ValueError(msg)
        if t.dtype != dtype or not t.is_contiguous():
            msg = f"{name} must be contiguous {dtype}, got {t.dtype}"
            raise ValueError(msg)
    P, W = px.numel(), walls.shape[0]
    if py.numel() != P or tuple(txs.shape[1:]) != (2,) or tuple(walls.shape[1:]) != (2, 2):
        msg = "bad shapes: px/py [P], txs [T, 2], walls [W, 2, 2]"
        raise ValueError(msg)
    if P >= 2**31:
        msg = f"the kernels take P < 2**31 pixels, got {P}"
        raise ValueError(msg)
    host = [_host_float(v) for v in scalars]
    return [
        _soft_mode(approx, sigmoid), px.data_ptr(), py.data_ptr(), P,
        txs.data_ptr(), txs.shape[0], walls.data_ptr(), kind.data_ptr(),
        phi.data_ptr(), W, inputs.cand.data_ptr(), inputs.num_candidates, *host,
    ]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = f"{name} launch failed: cudaError {rc}"
        raise RuntimeError(msg)


def value(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs, *,
          approx: bool, sigmoid: bool) -> torch.Tensor:
    """Value map ``[P]`` through ``power_map_value`` (CUDA tensors) or its
    plain version (CPU tensors)."""
    if px.device.type == "cpu":
        return plain_value(px, py, txs, walls, kind, phi, scalars, inputs)
    if px.device.type != "cuda":
        msg = f"power_map_value runs on CUDA or CPU tensors, got {px.device}"
        raise ValueError(msg)
    args = _launch_args(px, py, txs, walls, kind, phi, scalars, inputs, approx, sigmoid)
    out = torch.empty_like(px)
    if px.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        rc = lib.power_map_value(*args, out.data_ptr(), stream)
    _check(rc, "power_map_value")
    LAUNCHES["power_map_value"] += 1
    return out


def value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs,
                   *, approx: bool, sigmoid: bool):
    """``(value[P], pixel_gradient[P, 2])`` through ``power_map_vag`` (CUDA
    tensors) or its plain version (CPU tensors)."""
    if px.device.type == "cpu":
        return plain_value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs)
    if px.device.type != "cuda":
        msg = f"power_map_vag runs on CUDA or CPU tensors, got {px.device}"
        raise ValueError(msg)
    args = _launch_args(px, py, txs, walls, kind, phi, scalars, inputs, approx, sigmoid)
    out = torch.empty_like(px)
    gout = torch.empty(px.numel(), 2, dtype=px.dtype, device=px.device)
    if px.numel() == 0:
        return out, gout
    lib = load_library()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        rc = lib.power_map_vag(*args, out.data_ptr(), gout.data_ptr(), stream)
    _check(rc, "power_map_vag")
    LAUNCHES["power_map_vag"] += 1
    return out, gout


class PowerMapFunction(torch.autograd.Function):
    """Value map: the kernel forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, px, py, txs, walls, phi, scal, kind, host_scalars, inputs,
                approx, sigmoid):
        ctx.save_for_backward(px, py, txs, walls, phi, scal, kind)
        ctx.eager = inputs.eager
        return value(px, py, txs, walls, kind, phi, host_scalars, inputs,
                     approx=approx, sigmoid=sigmoid)

    @staticmethod
    def backward(ctx, g):
        return (*eager_backward(ctx, g), None, None, None, None, None)


def eager_backward(ctx, g):
    """Gradients of ``(px, py, txs, walls, phi, scal)`` from the plain
    version's VJP, for a Function that saved those tensors and ``kind``
    and set ``ctx.eager`` (its :class:`eager.EagerSpec`)."""
    px, py, txs, walls, phi, scal, kind = ctx.saved_tensors
    need = ctx.needs_input_grad
    pixels = torch.stack([px, py], dim=-1)
    gpix, gtx, gwalls, gphi, gscal = eager.eager_vjp(
        pixels, txs, walls, kind, phi, scal, ctx.eager, g.contiguous(),
        needs=(need[0] or need[1], need[2], need[3], need[4], need[5]),
    )
    gpx = gpix[:, 0] if need[0] else None
    gpy = gpix[:, 1] if need[1] else None
    return gpx, gpy, gtx, gwalls, gphi, gscal


def request_tensors(scene, X, Y, on_transmitters: bool):
    """``(px[P], py[P], txs[T, 2], walls)`` of a map request on the ``X``/``Y``
    grids, each contiguous.  With ``on_transmitters`` the scene's ends are
    swapped (path reversal, exact for walls and vertices; the caller keeps
    RIS scenes off this path)."""
    target = scene.swap_ends() if on_transmitters else scene
    txs = (
        torch.stack(list(target.transmitters.values()))
        if target.transmitters
        else torch.zeros(0, 2, device=X.device)
    ).contiguous()
    return X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), txs, scene.walls.contiguous()


def tracked_scalars(tensors, scalars: tuple):
    """``(scal[5], host scalars)`` for a differentiable value map when
    autograd tracks one of ``tensors`` or ``scalars``, else None."""
    tracked = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (*tensors, *scalars)
    )
    if not tracked:
        return None
    dev = tensors[0].device
    scal = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev) for v in scalars])
    return scal, tuple(_host_float(v) for v in scalars)


def power_map_kernel(scene, X, Y, groups: dict, *, want_grad: bool, approx: bool,
                     sigmoid: bool, on_transmitters: bool, scalars: tuple):
    """Flat map of the ``X``/``Y`` grid through the kernels: ``[P]``, or
    ``([P], [P, 2])`` with ``want_grad`` (terminal, not differentiable)."""
    px, py, txs, walls = request_tensors(scene, X, Y, on_transmitters)
    inputs = kernel_inputs(groups, X.device, approx=approx, sigmoid=sigmoid)
    args = (px, py, txs, walls, scene.kind, scene.phi)
    if want_grad:
        return value_and_grad(*args, scalars, inputs, approx=approx, sigmoid=sigmoid)
    diff = tracked_scalars((px, py, txs, walls, scene.phi), scalars)
    if diff is None:
        return value(*args, scalars, inputs, approx=approx, sigmoid=sigmoid)
    scal, host = diff
    return PowerMapFunction.apply(
        px, py, txs, walls, scene.phi, scal, scene.kind, host, inputs, approx, sigmoid
    )
