"""Wrappers of the power-map CUDA kernels, with their plain versions.

Two hand-written kernels in ``csrc/power_map.cu`` replace the unrolled
Pallas kernel ``differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel``:

* ``power_map_value`` -- its ``mode="value"``: the map ``[P]``;
* ``power_map_vag`` -- its ``mode="value_and_grad"``: the map and its
  pixel gradient ``([P], [P, 2])``.

Both run the looped kernels' redesigned blocked sweep over all walls
(rejection of clear misses without a division with the bounds of
:func:`rejection_bounds`, warp-wide exits; the value kernel in its margin
form, the gradient kernel with the winning wall's partials only).  The same
source exports each sweep as it was, ``power_map_value_seq``
(:func:`twin_value`) and ``power_map_vag_seq`` (:func:`twin_value_and_grad`):
the redesigns' bitwise references, for checks only; the dispatch never
calls them.

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
import functools
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch._C._functorch import is_functorch_wrapped_tensor

from .. import eager, logic, optimize
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
TWIN_LAUNCHES = {"power_map_value_seq": 0, "power_map_vag_seq": 0}
"""Launches of the sequential-sweep twins (:func:`twin_value`,
:func:`twin_value_and_grad`), which only checks call."""

_INPUTS_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_INPUTS_CACHE_MAX = 64


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_LAUNCHES):
        for name in counts:
            counts[name] = 0


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
    entry = optimize.constants(make())
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
                function=logic._sigmoid if sigmoid else logic._hard_sigmoid,
            ),
        )

    return cached_inputs("unrolled", groups, device, approx, sigmoid, make)


# -- rejection bounds of the redesigned blocked sweep (power_map.cu, looped kernels) --

SIGMOID_VALUE_FLOOR = -18.0
"""Margin at and below which the kernels' ``1 - clip(sigm(m), 0, 1)`` is
exactly 1 (``sigm(-18)`` is about 1.5e-8, under half an ulp of 1), held
for every float32 at or below it by :func:`sigmoid_bands`."""
SIGMOID_VAG_FLOOR = -89.0
"""Margin at and below which the kernels' ``sigm(m)`` is exactly 0
(``expf(89)`` overflows), held the same way: the value and gradient map's
rejected tests must have a hit of exactly 0."""
SIGMOID_SAT = 19.0
"""Margin at and above which ``1 - clip(sigm(m), 0, 1)`` is exactly 0 (the
value kernel's early exit), held the same way."""
REJECT_MIN_DEN = 2.0 ** -90
"""Least ``|den|`` the rejection test takes (keeps its products normal)."""
_REJECT_SLACK = 2.0 ** -20
"""Relative widening of the bounds on ``t``: covers the rounding of the
product ``|den| * bound`` (2**-24) with room."""


def _f32_key(x: np.ndarray) -> np.ndarray:
    """Order-preserving int64 key of float32 values (-0 and +0 share 0)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    return np.where(b >= 2**31, -(b - 2**31), b)


def _f32_of_key(k) -> np.ndarray:
    k = np.asarray(k, np.int64)
    b = np.where(k < 0, (-k) + 2**31, k).astype(np.uint32)
    return b.view(np.float32)


def _last_true(pred, lo_key: int, hi_key: int) -> Optional[int]:
    """Largest key in ``[lo_key, hi_key]`` where the monotone (true, then
    false) ``pred`` of the float32 holds, or None."""
    if not pred(_f32_of_key(lo_key)):
        return None
    lo, hi = lo_key, hi_key
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pred(_f32_of_key(mid)):
            lo = mid
        else:
            hi = mid - 1
    return lo


def rejection_bounds(alpha: float, soft_mode: int, grad: bool, sigmoid_bands_ok: bool = True):
    """``(tlo, thi, sat)`` of the redesigned kernels, as float32 numbers.

    A blocked test whose parameter ``t = num / den`` (either of the two)
    is at most ``tlo`` or at least ``thi`` has a margin at or below the
    floor where its hit is exactly 0 (value: the map's ``1 - act`` is
    exactly 1), so the kernels skip it without dividing; they decide it from
    ``num`` and ``|den| * bound`` (:func:`rejects`).  The floors: hard logic,
    a miss; ``hard_sigmoid``, margin 0; sigmoid, :data:`SIGMOID_VALUE_FLOOR`
    or, with the gradient, :data:`SIGMOID_VAG_FLOOR` (only where
    ``sigmoid_bands_ok``).  ``tlo`` is the largest float32 ``t`` whose
    margin ``alpha * (t + 0.005) [+ 3]`` is at or below the floor,
    computed in float32 as the kernels compute it, then widened by
    :data:`_REJECT_SLACK`; ``thi`` likewise from ``alpha * (1.005 - t) [+
    3]``.  A side that cannot be bounded is ``-inf`` / ``inf`` (no test is
    rejected on it).  ``sat`` is the running margin at and above which the
    value kernel's path is fully blocked (hit 1 for hard logic; 6 for
    ``hard_sigmoid``; :data:`SIGMOID_SAT`), ``inf`` where unproven.
    """
    inf = float("inf")
    f32 = np.float32
    tol, one_tol = f32(0.005), f32(1.005)
    if soft_mode == SOFT_NONE:
        tlo = float(np.nextafter(-tol, f32(-inf)))
        thi = float(np.nextafter(one_tol, f32(inf)))
        return _widen(tlo, thi) + (1.0,)
    a = f32(alpha)
    hard = soft_mode == SOFT_HARD
    if not (np.isfinite(a) and a > 0) or not (hard or sigmoid_bands_ok):
        return -inf, inf, inf
    floor = f32(0.0) if hard else f32(SIGMOID_VAG_FLOOR if grad else SIGMOID_VALUE_FLOOR)
    three = f32(3.0) if hard else f32(0.0)

    def lo_ok(t):
        with np.errstate(over="ignore", invalid="ignore"):
            return bool(f32(f32(a * f32(f32(t) + tol)) + three) <= floor)

    def hi_ok(t):
        with np.errstate(over="ignore", invalid="ignore"):
            return bool(f32(f32(a * f32(one_tol - f32(t))) + three) <= floor)

    kmax = int(_f32_key(np.float32(np.finfo(np.float32).max)))
    klo = _last_true(lo_ok, -kmax, kmax)
    # hi_ok is false, then true: search the last false, step one up.
    khi = _last_true(lambda t: not hi_ok(t), -kmax, kmax)
    tlo = -inf if klo is None else float(_f32_of_key(klo))
    thi = inf if khi is None or khi == kmax else float(_f32_of_key(khi + 1))
    sat = 6.0 if hard else SIGMOID_SAT
    return _widen(tlo, thi) + (sat,)


def _widen(tlo: float, thi: float) -> tuple:
    """The bounds widened by :data:`_REJECT_SLACK`, rounded outwards to
    float32; a side closer to 0 than 2**-20 (its products could leave the
    normal range) is dropped."""
    inf = float("inf")
    out = []
    for t, side in ((tlo, -1.0), (thi, 1.0)):
        if not np.isfinite(t) or t * side < 2.0 ** -20:
            out.append(side * inf)
            continue
        w = t * (1.0 + _REJECT_SLACK)
        f = np.float32(w)
        if float(f) * side < w * side:
            f = np.nextafter(f, np.float32(side * inf))
        out.append(float(f))
    return tuple(out)


def rejects(num_a, num_b, den, tlo: float, thi: float):
    """The kernels' rejection test of a blocked test from its float32
    ``num_a``, ``num_b`` and ``den`` (``seg_margin``'s): true only where
    ``t_a`` or ``t_b``, divided as the kernels divide, is at most ``tlo``
    or at least ``thi``.  ``t = s / d`` with ``s = num`` and ``d = den``,
    or both negated where ``den < 0`` (the same quotient, rounded the
    same); with ``d >= REJECT_MIN_DEN`` and finite ``s`` and ``d``,
    ``s <= fl(d * tlo)`` implies ``s <= d * tlo / (1 - 2**-24) <= d *
    tlo_unwidened`` exactly, hence ``fl(s / d) <= tlo_unwidened`` (division
    rounds monotonically), and likewise for ``thi``."""
    neg = den < 0
    sa = torch.where(neg, -num_a, num_a)
    sb = torch.where(neg, -num_b, num_b)
    d = den.abs()
    inf = float("inf")
    ok = (d >= REJECT_MIN_DEN) & (d < inf) & (sa.abs() < inf) & (sb.abs() < inf)
    lo = d * torch.tensor(tlo, dtype=torch.float32, device=den.device)
    hi = d * torch.tensor(thi, dtype=torch.float32, device=den.device)
    return ok & ((sa <= lo) | (sa >= hi) | (sb <= lo) | (sb >= hi))


@functools.lru_cache(maxsize=64)
def _bounds(alpha: float, soft_mode: int, grad: bool, bands_ok: bool) -> tuple:
    return rejection_bounds(alpha, soft_mode, grad, bands_ok)


GATE_EXIT = 1
"""The kernels' ``features`` bit for the gate exits (``kGateExit``)."""

_SIGMOID_BANDS: dict = {}


def _band_fails(cache: dict, dev: torch.device, probe) -> tuple:
    """Per band of :func:`sigmoid_bands`, the float32 values where the
    sigmoid of the library whose ``sigmoid_band_probe`` is ``probe()``
    breaks it on ``dev`` (about 3e9 values in all), once per device and
    library (``cache``)."""
    key = str(dev)
    fails = cache.get(key)
    if fails is None:
        counts = torch.zeros(3, dtype=torch.int32, device=dev)
        fn = probe()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for test, bound in enumerate((SIGMOID_VALUE_FLOOR, SIGMOID_VAG_FLOOR, SIGMOID_SAT)):
                _check(fn(bound, test, counts[test:].data_ptr(), stream), "sigmoid_band_probe")
        fails = tuple(counts.tolist())
        cache[key] = fails
    return fails


def sigmoid_bands(device) -> bool:
    """Whether the sigmoid of ``csrc/power_map.cu`` on ``device`` keeps,
    for every float32 of each band, ``1 - clip(sigm(z), 0, 1) == 1`` for
    ``z <= SIGMOID_VALUE_FLOOR``, ``sigm(z) == 0`` for ``z <=
    SIGMOID_VAG_FLOOR`` and ``1 - clip(sigm(z), 0, 1) == 0`` for ``z >=
    SIGMOID_SAT`` (``power_map_sigmoid_band_probe``).  Where they fail,
    sigmoid maps run without the rejection and the saturation exit
    (:func:`rejection_bounds`).  True on the CPU, where the plain version
    rejects nothing."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    return not any(_band_fails(_SIGMOID_BANDS, dev,
                               lambda: load_library().power_map_sigmoid_band_probe))
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
    common = [_I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I]
    scalars = [_F, _F, _F, _F, _F]
    for name in ("power_map_value", "power_map_value_seq"):
        getattr(lib, name).argtypes = [*common, _F, _F, _F, *scalars, _P, _P]
        getattr(lib, name).restype = _I
    for name in ("power_map_vag", "power_map_vag_seq"):
        getattr(lib, name).argtypes = [*common, _F, _F, _F, *scalars, _P, _P, _P]
        getattr(lib, name).restype = _I
    lib.power_map_occupancy.argtypes = [_I, _I, _I, _I, _P]
    lib.power_map_occupancy.restype = _I
    lib.power_map_sigmoid_band_probe.argtypes = [_F, _I, _P, _P]
    lib.power_map_sigmoid_band_probe.restype = _I


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
    return [
        _soft_mode(approx, sigmoid), px.data_ptr(), py.data_ptr(), P,
        txs.data_ptr(), txs.shape[0], walls.data_ptr(), kind.data_ptr(),
        phi.data_ptr(), W, inputs.cand.data_ptr(), inputs.num_candidates,
    ]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = f"{name} launch failed: cudaError {rc}"
        raise RuntimeError(msg)


def _launch_bounds(px, approx: bool, sigmoid: bool, grad: bool, alpha: float) -> tuple:
    """``(tlo, thi, sat)`` of a redesigned kernel's launch on ``px``'s card:
    :func:`rejection_bounds`, with the sigmoid's bands held on the card."""
    return _bounds(alpha, _soft_mode(approx, sigmoid), grad,
                   bool(not sigmoid or sigmoid_bands(px.device)))


def _launch(name, grad: bool, px, py, txs, walls, kind, phi, scalars, inputs, approx,
            sigmoid, counts):
    """The map of kernel ``name`` on CUDA tensors (a value kernel, or with
    ``grad`` a value and gradient kernel: ``(value, gradient)``);
    ``counts[name]`` counts the launch."""
    args = _launch_args(px, py, txs, walls, kind, phi, scalars, inputs, approx, sigmoid)
    host = [_host_float(v) for v in scalars]
    tlo, thi, sat = _launch_bounds(px, approx, sigmoid, grad, host[0])
    out = torch.empty_like(px)
    outs = (out, torch.empty(px.numel(), 2, dtype=px.dtype, device=px.device)) if grad else (out,)
    if px.numel() != 0:
        lib = load_library()
        with torch.cuda.device(px.device):
            stream = torch.cuda.current_stream(px.device).cuda_stream
            rc = getattr(lib, name)(*args, tlo, thi, sat, *host, *(o.data_ptr() for o in outs),
                                    stream)
        _check(rc, name)
        counts[name] += 1
    return outs if grad else out


def value(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs, *,
          approx: bool, sigmoid: bool) -> torch.Tensor:
    """Value map ``[P]`` through ``power_map_value`` (CUDA tensors) or its
    plain version (CPU tensors)."""
    if _device_kind(px, "power_map_value") == "cpu":
        return plain_value(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("power_map_value", False, px, py, txs, walls, kind, phi, scalars, inputs,
                   approx, sigmoid, LAUNCHES)


def twin_value(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs, *,
               approx: bool, sigmoid: bool) -> torch.Tensor:
    """:func:`value` through ``power_map_value_seq``, the sequential sweep
    that the redesigned kernel must equal bit for bit (CUDA tensors; the
    plain version on the CPU).  For checks only: the dispatch never calls
    it."""
    if _device_kind(px, "power_map_value_seq") == "cpu":
        return plain_value(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("power_map_value_seq", False, px, py, txs, walls, kind, phi, scalars,
                   inputs, approx, sigmoid, TWIN_LAUNCHES)


def _device_kind(px, name: str) -> str:
    """``"cpu"`` (the plain version's tensors) or ``"cuda"``; raises for
    any other device."""
    if px.device.type not in ("cpu", "cuda"):
        msg = f"{name} runs on CUDA or CPU tensors, got {px.device}"
        raise ValueError(msg)
    return px.device.type


def value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs,
                   *, approx: bool, sigmoid: bool):
    """``(value[P], pixel_gradient[P, 2])`` through ``power_map_vag`` (CUDA
    tensors) or its plain version (CPU tensors)."""
    if _device_kind(px, "power_map_vag") == "cpu":
        return plain_value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("power_map_vag", True, px, py, txs, walls, kind, phi, scalars, inputs,
                   approx, sigmoid, LAUNCHES)


def twin_value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs: KernelInputs,
                        *, approx: bool, sigmoid: bool):
    """:func:`value_and_grad` through ``power_map_vag_seq``, the sequential
    sweep that the redesigned kernel must equal bit for bit (CUDA tensors;
    the plain version on the CPU).  For checks only: the dispatch never
    calls it."""
    if _device_kind(px, "power_map_vag_seq") == "cpu":
        return plain_value_and_grad(px, py, txs, walls, kind, phi, scalars, inputs)
    return _launch("power_map_vag_seq", True, px, py, txs, walls, kind, phi, scalars, inputs,
                   approx, sigmoid, TWIN_LAUNCHES)


def occupancy(grad: bool, soft_mode: int, fast: bool, num_walls: int) -> int:
    """Resident blocks per SM of a kernel of ``csrc/power_map.cu`` on the
    current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    _check(load_library().power_map_occupancy(int(grad), soft_mode, int(fast), num_walls,
                                              ctypes.byref(blocks)), "power_map_occupancy")
    return blocks.value


class PowerMapFunction(torch.autograd.Function):
    """Value map: the kernel forward, the plain version's derivatives
    (VJP backward, JVP forward mode)."""

    @staticmethod
    def forward(px, py, txs, walls, phi, scal, kind, host_scalars, inputs, approx, sigmoid):
        return value(px, py, txs, walls, kind, phi, host_scalars, inputs,
                     approx=approx, sigmoid=sigmoid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        save_inputs(ctx, inputs)

    @staticmethod
    def backward(ctx, g):
        return (*eager_backward(ctx, g), None, None, None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        return eager_jvp(ctx, tangents)


def save_inputs(ctx, inputs) -> None:
    """``setup_context`` of a map Function whose inputs begin ``(px, py,
    txs, walls, phi, scal, kind, host_scalars, inputs)``: saves the tensors
    for both modes and the inputs' :class:`eager.EagerSpec`."""
    px, py, txs, walls, phi, scal, kind, _, kernel_inputs = inputs[:9]
    ctx.save_for_backward(px, py, txs, walls, phi, scal, kind)
    ctx.save_for_forward(px, py, txs, walls, phi, scal, kind)
    ctx.eager = kernel_inputs.eager


def eager_backward(ctx, g):
    """Gradients of ``(px, py, txs, walls, phi, scal)`` from the plain
    version's VJP, for a Function set up by :func:`save_inputs`."""
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


def eager_jvp(ctx, tangents):
    """Tangent of the map along the tangents of ``(px, py, txs, walls, phi,
    scal)`` (None for none), by ``torch.func.jvp`` over the plain version,
    for a Function set up by :func:`save_inputs`: the kernel stays the
    forward pass, as the plain VJP is its backward."""
    px, py, txs, walls, phi, scal, kind = ctx.saved_tensors
    primals = (px, py, txs, walls, phi, scal)
    dots = tuple(torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents))

    def plain(px, py, txs, walls, phi, scal):
        pixels = torch.stack([px, py], dim=-1)
        return eager.eager_value(pixels, txs, walls, kind, phi, tuple(scal.unbind()), ctx.eager)

    out, tangent = optimize.jvp(plain, primals, dots)
    return tangent.to(out.dtype)


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
    autograd, or a ``torch.func`` transform, tracks one of ``tensors`` or
    ``scalars``, else None.  Raises for forward-mode tangents of
    ``torch.autograd.forward_ad``, which the maps' Functions cannot take
    (``torch.func.jvp``, as ``optimize.value_and_grad_fwd`` runs it, can)."""
    values = (*tensors, *scalars)
    if any(isinstance(t, torch.Tensor) and not is_functorch_wrapped_tensor(t)
           and fwAD.unpack_dual(t).tangent is not None for t in values):
        msg = ("forward-mode tangents reach the kernels' maps through torch.func.jvp"
               " (optimize.value_and_grad_fwd), not torch.autograd.forward_ad dual tensors")
        raise NotImplementedError(msg)
    tracked = optimize.transformed(values) or torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in values
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
