"""Wrappers of the looped power-map CUDA kernels, with their plain versions.

Two hand-written kernels in ``csrc/power_map_looped.cu`` replace the looped
Pallas kernel ``differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel_looped``
with ``cull=True, shadow=True`` on candidates of order <= 1 (B3, B4 and the
list form of B5):

* ``power_map_looped_value`` -- the map ``[P]``;
* ``power_map_looped_vag`` -- the map and its pixel gradient
  ``([P], [P, 2])``.

A request is planned per transmitter (:func:`make_plan`): the per-launch
constants (unit normals and patched endpoints of the walls, the
transmitter's mirror image per candidate), the culling tiles' bounds, and
the tables of :mod:`.cull_tables` in the kernels' form.  ``cull=False``
gives every tile every candidate, ``shadow=False`` every segment every
wall: with both off ("identity tables") the same program is the unculled
looped kernel, and its maps equal the culled ones bit for bit.

Beside each kernel is its plain PyTorch version (:func:`plain_looped_value`,
:func:`plain_looped_value_and_grad`: the eager tracer with the same tables
applied as masks).  A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
:data:`LAUNCHES` counts launches (one per transmitter and map).
:class:`LoopedMapFunction` makes the value map differentiable: the kernel
forward, the eager tracer's VJP backward.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import eager, logic
from . import _build, cull_tables
from .power_map_kernel import (
    _check,
    _host_float,
    _soft_mode,
    cached_inputs,
    eager_backward,
    request_tensors,
    tracked_scalars,
)

SOURCE = "power_map_looped.cu"
MAX_ORDER = 1
"""Highest candidate order the looped kernels take (``LP_MAX_ORDER``)."""
MAX_WALLS = 512
"""Most objects the looped kernels take (``LP_MAX_WALLS``, shared memory)."""
MAX_THREADS = 256
"""Most pixels in a culling tile (``LP_MAX_THREADS``, threads per block)."""

TILE = (16, 16)
"""Culling tile ``(columns, rows)`` of the receiver grid: one block each.
Chosen on an H100 for the 1024 x 1024 city extract map only (PERF.md,
Findings; the sweep is :mod:`.looped_tuning`): tables plus kernel took
least time at 16 x 16 among 8 x 8, 16 x 8, 16 x 16, 32 x 8 and 8 x 32 (the
table build grows with the tile count, the kernel barely moves).  Smaller
grids were not tuned: at 256 x 256 the table build alone costs more than
the unculled kernel."""
REFINE = 4
"""Sub-boxes per tile side in :func:`cull_tables.beam_keep_tables`.
Chosen with :data:`TILE`, on the same map: refine 4 built its tables in
about half the time of refine 8, and the culled kernel ran as fast (the
extra candidates it keeps are a fraction of a percent of the work); 16
doubles the build again."""

LAUNCHES = {"power_map_looped_value": 0, "power_map_looped_vag": 0}
"""Launches of each kernel since the process started (or was reset)."""

_SIGMOID_SATURATES: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_caps_reason(num_walls: int, max_order: int) -> Optional[str]:
    """Why the looped kernels cannot take this request, or None."""
    if num_walls > MAX_WALLS:
        return f"the looped CUDA kernels hold at most {MAX_WALLS} objects, got {num_walls}"
    if max_order > MAX_ORDER:
        return f"the looped CUDA kernels take orders <= {MAX_ORDER}, got {max_order}"
    return None


@dataclasses.dataclass(frozen=True)
class LoopedInputs:
    """Device inputs derived from a candidate set of orders <= 1.

    ``cand`` is ``int32[C]``, the wall of each order-1 candidate; ``groups``
    the host candidate matrices; ``eager`` the same set for the plain
    versions and the backward.
    """

    cand: torch.Tensor
    has_los: bool
    groups: dict
    eager: eager.EagerSpec

    @property
    def num_candidates(self) -> int:
        return int(self.cand.shape[0])


def looped_inputs(groups: dict, device, *, approx: bool, sigmoid: bool) -> LoopedInputs:
    """Cached :class:`LoopedInputs` (``power_map_kernel.cached_inputs``)."""
    if any(o > MAX_ORDER and g.shape[0] for o, g in groups.items()):
        msg = f"the looped kernels take orders <= {MAX_ORDER}, got {sorted(groups)}"
        raise ValueError(msg)

    def make():
        g1 = np.asarray(groups.get(1, np.zeros((0, 1), np.int32)), np.int32).reshape(-1, 1)
        return LoopedInputs(
            cand=torch.from_numpy(np.array(g1[:, 0], dtype=np.int32)).to(device),
            has_los=bool(0 in groups and groups[0].shape[0]),
            groups={o: np.asarray(g) for o, g in groups.items() if g.shape[0]},
            eager=eager.EagerSpec(
                groups=eager.make_groups(groups, device),
                approx=bool(approx),
                function=logic.sigmoid if sigmoid else logic.hard_sigmoid,
            ),
        )

    return cached_inputs("looped", groups, device, approx, sigmoid, make)


# -- plan: constants and tables ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tables:
    """The kernels' tables for one transmitter (layouts in the .cu header):
    ``prm int32[T, C]``, ``cnt int32[T]``, ``l0w int32[W, NW]``,
    ``lastw int32[T, W, NW]``, ``losw int32[T, NW]``."""

    prm: torch.Tensor
    cnt: torch.Tensor
    l0w: torch.Tensor
    lastw: torch.Tensor
    losw: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in dataclasses.astuple(self))


@dataclasses.dataclass(frozen=True)
class TxPlan:
    """One transmitter's launch: its position ``tx[2]``, the walls' unit
    normals and patched endpoints ``aux[W, 6]``, the candidates' mirror
    images ``img[C, 2]`` and the tables."""

    tx: torch.Tensor
    aux: torch.Tensor
    img: torch.Tensor
    tables: Tables


@dataclasses.dataclass(frozen=True)
class Plan:
    """A map's launches: the ``rows x cols`` grid cut into ``tile``
    (columns, rows) tiles, and one :class:`TxPlan` per transmitter."""

    rows: int
    cols: int
    tile: tuple
    per_tx: tuple

    @property
    def tiles(self) -> tuple:
        """``(tiles across, tiles down)``."""
        return -(-self.cols // self.tile[0]), -(-self.rows // self.tile[1])

    def tile_of(self, flat: torch.Tensor) -> torch.Tensor:
        """Tile index of each flat pixel index (as the kernels number blocks)."""
        row, col = flat // self.cols, flat % self.cols
        return (row // self.tile[1]) * self.tiles[0] + col // self.tile[0]


def tile_bounds(X: torch.Tensor, Y: torch.Tensor, tile=TILE):
    """``(x0, x1, y0, y1)``, each ``[T]``: the least and greatest pixel
    coordinates of each tile of the ``[rows, cols]`` grids (a ragged edge
    tile's missing pixels are left out)."""
    tw, th = tile
    rows, cols = X.shape
    nx, ny = -(-cols // tw), -(-rows // th)
    pad = (0, nx * tw - cols, 0, ny * th - rows)

    def blocks(A, fill):
        A = torch.nn.functional.pad(A[None], pad, value=fill)[0]
        return A.reshape(ny, th, nx, tw).permute(0, 2, 1, 3).reshape(ny * nx, th * tw)

    inf = float("inf")
    return (blocks(X, inf).amin(dim=1), blocks(X, -inf).amax(dim=1),
            blocks(Y, inf).amin(dim=1), blocks(Y, -inf).amax(dim=1))


def launch_constants(walls: torch.Tensor, tx: torch.Tensor, patch, inputs: LoopedInputs):
    """``(normals[W, 2], aux[W, 6], img[C, 2])``: unit normals, normals and
    patched endpoints as the kernels read them, and the transmitter's
    mirror image through each candidate's wall (the formulas of
    ``pallas_kernels.py:3251-3281``)."""
    a, b = walls[:, 0, :], walls[:, 1, :]
    t_vec = b - a
    n_raw = torch.stack([t_vec[:, 1], -t_vec[:, 0]], dim=-1)
    n_len = torch.sqrt(cull_tables._sum2(n_raw * n_raw))[:, None]
    normals = n_raw / torch.where(n_len == 0.0, torch.ones_like(n_len), n_len)
    patch_t = torch.as_tensor(patch, dtype=torch.float32, device=walls.device)
    aux = torch.cat([normals, a - patch_t * t_vec, b + patch_t * t_vec], dim=-1)
    idx = inputs.cand.long()
    wn, wa = normals[idx], walls[idx, 0, :]
    cur = tx[None, :].expand(idx.shape[0], 2)
    d = cull_tables._sum2((cur - wa) * wn)[:, None]
    img = cur - 2.0 * d * wn
    return normals, aux.contiguous(), img.contiguous()


# Elements of one slab of the last-segment masks ([tiles, W, W] bools).
_LAST_SLAB = 1 << 25


def build_tables(walls, kind, tx, normals, img, inputs: LoopedInputs, bounds,
                 scalars, *, approx: bool, sigmoid: bool, cull: bool, shadow: bool) -> Tables:
    """The kernels' tables for one transmitter: the beam proof's kept
    candidates (``cull``) and the occluder bit words (``shadow``).  Where a
    flag is off its tables are identity tables: every candidate in every
    tile, every wall on every list."""
    alpha, tol, patch = scalars[0], scalars[1], scalars[2]
    x0, x1, y0, y1 = bounds
    T, C, W, dev = x0.shape[0], inputs.num_candidates, walls.shape[0], walls.device
    nw = -(-W // 32)
    every_wall = cull_tables.pack_words(torch.ones(W, dtype=torch.bool, device=dev))
    prm = torch.arange(C, dtype=torch.int32, device=dev).expand(T, C).contiguous()
    cnt = torch.full((T,), C, dtype=torch.int32, device=dev)
    if cull and C:
        keep = cull_tables.beam_keep_tables(
            walls, normals, kind, inputs.groups, [1], {1: img[:, None, :]},
            x0, x1, y0, y1, approx=approx, alpha=alpha, tx=tx, patch=patch,
            refine=REFINE, sigmoid=sigmoid, tol=tol,
        )[1]
        prm, cnt = cull_tables.keep_lists(keep)
    if shadow:
        geo = cull_tables._shadow_geometry(walls, kind, tx, patch, alpha, approx, sigmoid, tol)
        step = max(1, _LAST_SLAB // max(W * W, 1))
        lastw = torch.cat([
            cull_tables.pack_words(cull_tables.last_masks(
                geo, x0[s:s + step], x1[s:s + step], y0[s:s + step], y1[s:s + step]))
            for s in range(0, T, step)
        ])
        l0w = cull_tables.pack_words(cull_tables.first_masks(geo, tx))
        # The un == 0 hazard gate: every wall on the first and last lists.
        l0w = torch.where(geo["hz_free"], l0w, every_wall)
        lastw = torch.where(geo["hz_free"], lastw, every_wall)
        losw = cull_tables.pack_words(cull_tables.los_masks(geo, tx, x0, x1, y0, y1))
    else:
        l0w = every_wall.expand(W, nw)
        lastw = every_wall.expand(T, W, nw)
        losw = every_wall.expand(T, nw)
    return Tables(prm=prm, cnt=cnt, l0w=l0w.contiguous(), lastw=lastw.contiguous(),
                  losw=losw.contiguous())


def make_plan(X, Y, txs, walls, kind, scalars, inputs: LoopedInputs, *, approx: bool,
              sigmoid: bool, cull: bool = True, shadow: bool = True, tile=TILE) -> Plan:
    """Constants and tables of every transmitter's launch for the
    ``[rows, cols]`` grids ``X``/``Y``."""
    if X.dim() != 2 or X.shape != Y.shape:
        msg = f"X and Y must be equal 2-D grids, got {tuple(X.shape)} and {tuple(Y.shape)}"
        raise ValueError(msg)
    if tile[0] * tile[1] > MAX_THREADS or min(tile) < 1:
        msg = f"a tile holds 1 to {MAX_THREADS} pixels, got {tile}"
        raise ValueError(msg)
    host = tuple(_host_float(v) for v in scalars)
    with torch.no_grad():
        walls = walls.detach()
        bounds = tile_bounds(X.detach(), Y.detach(), tile)
        per_tx = []
        for t in range(txs.shape[0]):
            tx = txs[t].detach()
            normals, aux, img = launch_constants(walls, tx, host[2], inputs)
            tables = build_tables(walls, kind, tx, normals, img, inputs, bounds, host,
                                  approx=approx, sigmoid=sigmoid, cull=cull,
                                  shadow=shadow)
            per_tx.append(TxPlan(tx=tx.contiguous(), aux=aux, img=img, tables=tables))
    return Plan(rows=X.shape[0], cols=X.shape[1], tile=tuple(tile), per_tx=tuple(per_tx))


# -- plain versions ---------------------------------------------------------------


def _keep_mask(tables: Tables, C: int) -> torch.Tensor:
    """``keep[T, C]`` bool from the kept-first lists."""
    T = tables.cnt.shape[0]
    rank = torch.arange(C, device=tables.cnt.device)[None, :].expand(T, C)
    keep = torch.zeros(T, C, dtype=torch.bool, device=tables.cnt.device)
    return keep.scatter(1, tables.prm.long(), rank < tables.cnt[:, None].long())


def _plain_chunk(p, flat, walls, kind, phi, scalars, inputs: LoopedInputs, plan: Plan,
                 masks):
    """Map of one pixel chunk (``p[n, 2]`` at flat indices ``flat[n]``),
    summed over the transmitters; differentiable in ``p``."""
    alpha, tol, patch, r_coef, height = scalars
    arrays = eager.SceneArrays(walls=walls, kind=kind, phi=phi)
    spec = inputs.eager
    tile = plan.tile_of(flat)
    rx = p.reshape(-1, 1, 2)
    out = None
    for tp, (keep, l0, last, los) in zip(plan.per_tx, masks):
        tx = tp.tx.reshape(1, 1, 2)
        acc = torch.zeros(p.shape[0], device=p.device)
        for order, cand in spec.groups:
            if cand.shape[0] == 0:
                continue
            if order == 0:
                listed = los[tile][:, None, None, :]
            else:
                w0 = cand[:, 0]
                listed = torch.stack(
                    [l0[w0][None].expand(p.shape[0], -1, -1), last[tile][:, w0]], dim=2
                )
            pts_full, _, valid = eager._trace_group(
                tx, rx, arrays, order, cand, approx=spec.approx, alpha=alpha,
                function=spec.function, tol=tol, patch=patch, listed=listed,
            )
            c = valid * eager._received_power_batched(pts_full, order, r_coef, height)
            if order == 1:
                c = torch.where(keep[tile], c, torch.zeros_like(c))
            acc = acc + torch.sum(c, dim=-1)
        out = acc if out is None else out + acc
    return torch.zeros(p.shape[0], device=p.device) if out is None else out


def _plain_masks(plan: Plan, W: int, C: int):
    return [
        (_keep_mask(tp.tables, C),
         cull_tables.unpack_words(tp.tables.l0w, W),
         cull_tables.unpack_words(tp.tables.lastw, W),
         cull_tables.unpack_words(tp.tables.losw, W))
        for tp in plan.per_tx
    ]


def plain_looped_value(px, py, walls, kind, phi, scalars, inputs: LoopedInputs,
                       plan: Plan) -> torch.Tensor:
    """Plain PyTorch version of ``power_map_looped_value``: ``[P]``."""
    pixels = torch.stack([px, py], dim=-1)
    masks = _plain_masks(plan, walls.shape[0], inputs.num_candidates)
    flat = torch.arange(px.shape[0], device=px.device)
    step = inputs.eager.chunk(walls.shape[0])
    with torch.no_grad():
        parts = [
            _plain_chunk(pixels[s:s + step], flat[s:s + step], walls, kind, phi,
                         scalars, inputs, plan, masks)
            for s in range(0, px.shape[0], step)
        ]
    return torch.cat(parts) if parts else px.new_zeros(0)


def plain_looped_value_and_grad(px, py, walls, kind, phi, scalars,
                                inputs: LoopedInputs, plan: Plan):
    """Plain PyTorch version of ``power_map_looped_vag``: ``([P], [P, 2])``,
    the pixel gradient from autograd."""
    pixels = torch.stack([px, py], dim=-1).detach()
    masks = _plain_masks(plan, walls.shape[0], inputs.num_candidates)
    flat = torch.arange(px.shape[0], device=px.device)
    step = inputs.eager.chunk(walls.shape[0])
    walls, phi = walls.detach(), phi.detach()
    scalars = tuple(v.detach() if isinstance(v, torch.Tensor) else v for v in scalars)
    vals, grads = [], []
    for s in range(0, px.shape[0], step):
        with torch.enable_grad():
            p = pixels[s:s + step].requires_grad_(True)
            z = _plain_chunk(p, flat[s:s + step], walls, kind, phi, scalars, inputs,
                             plan, masks)
            (g,) = torch.autograd.grad(z.sum(), p)
        vals.append(z.detach())
        grads.append(g)
    if not vals:
        return px.new_zeros(0), px.new_zeros(0, 2)
    return torch.cat(vals), torch.cat(grads)


# -- kernels -------------------------------------------------------------------------

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _declare(lib: ctypes.CDLL) -> None:
    common = [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
              _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _I]
    lib.power_map_looped_value.argtypes = [*common, _P, _P]
    lib.power_map_looped_value.restype = _I
    lib.power_map_looped_vag.argtypes = [*common, _P, _P, _P]
    lib.power_map_looped_vag.restype = _I
    lib.sigmoid_probe.argtypes = [_P, _P, _I, _P]
    lib.sigmoid_probe.restype = _I


def load_library() -> ctypes.CDLL:
    """The kernels' library, built from ``csrc/power_map_looped.cu`` on first use."""
    return _build.load(SOURCE, _declare)


def _check_inputs(px, py, walls, kind, phi, inputs: LoopedInputs, plan: Plan) -> None:
    cap = kernel_caps_reason(walls.shape[0], max(inputs.groups, default=0))
    if cap is not None:
        raise ValueError(cap)
    dev = px.device
    named = [("px", px, torch.float32), ("py", py, torch.float32),
             ("walls", walls, torch.float32), ("kind", kind, torch.int32),
             ("phi", phi, torch.float32), ("cand", inputs.cand, torch.int32)]
    for t, tp in enumerate(plan.per_tx):
        named += [(f"tx[{t}]", tp.tx, torch.float32), ("aux", tp.aux, torch.float32),
                  ("img", tp.img, torch.float32)]
        named += [(f"tables.{f.name}", getattr(tp.tables, f.name), torch.int32)
                  for f in dataclasses.fields(Tables)]
    for name, t, dtype in named:
        if t.device != dev:
            msg = f"{name} is on {t.device}, expected {dev}"
            raise ValueError(msg)
        if t.dtype != dtype or not t.is_contiguous():
            msg = f"{name} must be contiguous {dtype}, got {t.dtype}"
            raise ValueError(msg)
    P, W, C = px.numel(), walls.shape[0], inputs.num_candidates
    T, nw = plan.tiles[0] * plan.tiles[1], -(-W // 32)
    if py.numel() != P or P != plan.rows * plan.cols or tuple(walls.shape[1:]) != (2, 2):
        msg = "bad shapes: px/py [rows * cols], walls [W, 2, 2]"
        raise ValueError(msg)
    if P >= 2**31:
        msg = f"the kernels take P < 2**31 pixels, got {P}"
        raise ValueError(msg)
    for tp in plan.per_tx:
        tb = tp.tables
        if (tuple(tb.prm.shape) != (T, C) or tuple(tb.cnt.shape) != (T,)
                or tuple(tb.l0w.shape) != (W, nw) or tuple(tb.lastw.shape) != (T, W, nw)
                or tuple(tb.losw.shape) != (T, nw) or tuple(tp.img.shape) != (C, 2)
                or tuple(tp.aux.shape) != (W, 6)):
            msg = f"tables do not fit {T} tiles, {C} candidates and {W} walls"
            raise ValueError(msg)


def _launch(name, px, py, walls, kind, phi, scalars, inputs, plan, approx, sigmoid,
            out, gout=None):
    _check_inputs(px, py, walls, kind, phi, inputs, plan)
    if px.numel() == 0:
        return
    lib = load_library()
    fn = getattr(lib, name)
    host = [_host_float(v) for v in scalars]
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        for t, tp in enumerate(plan.per_tx):
            tb = tp.tables
            args = [
                _soft_mode(approx, sigmoid), px.data_ptr(), py.data_ptr(), plan.rows,
                plan.cols, plan.tile[0], plan.tile[1], tp.tx.data_ptr(), walls.data_ptr(),
                tp.aux.data_ptr(), kind.data_ptr(), phi.data_ptr(), walls.shape[0],
                int(inputs.has_los), inputs.cand.data_ptr(), tp.img.data_ptr(),
                inputs.num_candidates, tb.prm.data_ptr(), tb.cnt.data_ptr(),
                tb.l0w.data_ptr(), tb.lastw.data_ptr(), tb.losw.data_ptr(), *host,
                int(t > 0), out.data_ptr(),
            ]
            if gout is not None:
                args.append(gout.data_ptr())
            _check(fn(*args, stream), name)
            LAUNCHES[name] += 1


def _device_kind(px, name: str) -> str:
    if px.device.type not in ("cpu", "cuda"):
        msg = f"{name} runs on CUDA or CPU tensors, got {px.device}"
        raise ValueError(msg)
    return px.device.type


def value(px, py, walls, kind, phi, scalars, inputs: LoopedInputs, plan: Plan, *,
          approx: bool, sigmoid: bool) -> torch.Tensor:
    """Value map ``[P]`` through ``power_map_looped_value`` (CUDA tensors,
    one launch per transmitter) or its plain version (CPU tensors)."""
    if _device_kind(px, "power_map_looped_value") == "cpu":
        return plain_looped_value(px, py, walls, kind, phi, scalars, inputs, plan)
    out = torch.zeros_like(px)
    _launch("power_map_looped_value", px, py, walls, kind, phi, scalars, inputs, plan,
            approx, sigmoid, out)
    return out


def value_and_grad(px, py, walls, kind, phi, scalars, inputs: LoopedInputs, plan: Plan,
                   *, approx: bool, sigmoid: bool):
    """``(value[P], pixel_gradient[P, 2])`` through ``power_map_looped_vag``
    (CUDA tensors) or its plain version (CPU tensors)."""
    if _device_kind(px, "power_map_looped_vag") == "cpu":
        return plain_looped_value_and_grad(px, py, walls, kind, phi, scalars, inputs, plan)
    out = torch.zeros_like(px)
    gout = torch.zeros(px.numel(), 2, dtype=px.dtype, device=px.device)
    _launch("power_map_looped_vag", px, py, walls, kind, phi, scalars, inputs, plan,
            approx, sigmoid, out, gout)
    return out, gout


class LoopedMapFunction(torch.autograd.Function):
    """Value map: the looped kernel forward, the plain tracer's VJP backward
    (unculled: the tables only drop exact zeros)."""

    @staticmethod
    def forward(ctx, px, py, txs, walls, phi, scal, kind, host_scalars, inputs, plan,
                approx, sigmoid):
        ctx.save_for_backward(px, py, txs, walls, phi, scal, kind)
        ctx.eager = inputs.eager
        return value(px, py, walls, kind, phi, host_scalars, inputs, plan,
                     approx=approx, sigmoid=sigmoid)

    @staticmethod
    def backward(ctx, g):
        return (*eager_backward(ctx, g), None, None, None, None, None, None)


def sigmoid_saturates(device) -> bool:
    """Whether the sigmoid that maps on ``device`` run through is exactly 0
    at ``-(Z0 - 1)`` and exactly 1 at ``Z1 - 1`` (``cull_tables._SIGMOID_Z0``
    and ``_SIGMOID_Z1``), as sigmoid culling needs: on a GPU the kernels'
    own ``1 / (1 + expf(-z))`` (``sigmoid_probe``), on the CPU the plain
    version's.  Checked once per device."""
    dev = torch.device(device)
    key = str(dev)
    hit = _SIGMOID_SATURATES.get(key)
    if hit is None:
        z = torch.tensor([-(cull_tables._SIGMOID_Z0 - 1.0), cull_tables._SIGMOID_Z1 - 1.0],
                         dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            out = torch.empty_like(z)
            lib = load_library()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                _check(lib.sigmoid_probe(z.data_ptr(), out.data_ptr(), 2, stream),
                       "sigmoid_probe")
        else:
            out = logic.sigmoid(z, 1.0)
        lo, hi = out.tolist()
        hit = lo == 0.0 and hi == 1.0
        _SIGMOID_SATURATES[key] = hit
    return hit


def power_map_looped(scene, X, Y, groups: dict, *, want_grad: bool, approx: bool,
                     sigmoid: bool, on_transmitters: bool, scalars: tuple, cull: bool,
                     shadow: bool):
    """Flat map of the ``X``/``Y`` grid through the looped kernels: ``[P]``,
    or ``([P], [P, 2])`` with ``want_grad`` (terminal, not differentiable).

    ``cull``/``shadow`` select the beam tables and the occluder lists (the
    caller's gates); ``on_transmitters`` as in ``power_map_kernel``.
    """
    px, py, txs, walls = request_tensors(scene, X, Y, on_transmitters)
    inputs = looped_inputs(groups, X.device, approx=approx, sigmoid=sigmoid)
    plan = make_plan(X, Y, txs, walls, scene.kind, scalars, inputs, approx=approx,
                     sigmoid=sigmoid, cull=cull, shadow=shadow)
    args = (px, py, walls, scene.kind, scene.phi)
    if want_grad:
        return value_and_grad(*args, scalars, inputs, plan, approx=approx, sigmoid=sigmoid)
    diff = tracked_scalars((px, py, txs, walls, scene.phi), scalars)
    if diff is None:
        return value(*args, scalars, inputs, plan, approx=approx, sigmoid=sigmoid)
    scal, host = diff
    return LoopedMapFunction.apply(px, py, txs, walls, scene.phi, scal, scene.kind, host,
                                   inputs, plan, approx, sigmoid)
