"""Wrappers of the looped power-map CUDA kernels, with their plain versions.

Two hand-written kernels in ``csrc/power_map_looped.cu`` replace the looped
Pallas kernel ``differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel_looped``
with ``cull=True, shadow=True`` on candidates of orders <= 4 (B3, B4 and
B5: occluder sets of the first, last, line-of-sight and middle segments):

* ``power_map_looped_value`` -- the map ``[P]``;
* ``power_map_looped_vag`` -- the map and its pixel gradient
  ``([P], [P, 2])``.

A request is planned per transmitter (:func:`make_plan`): the per-launch
constants (unit normals and patched endpoints of the walls, the
transmitter's mirror-image chain per candidate), the culling tiles' bounds,
and the tables of :mod:`.cull_tables` in the kernels' form.  ``cull=False``
gives every tile every candidate, ``shadow=False`` every segment every
wall: with both off ("identity tables") the same program is the unculled
looped kernel, and its maps equal the culled ones bit for bit.

Both run the redesigned blocked sweep (rejection of clear misses without a
division, the gradient of the winning wall only, warp-wide early exits,
tiles longest first: ``csrc/power_map_looped.cu``).  The same source
exports the sequential sweep as ``power_map_looped_value_seq`` and
``power_map_looped_vag_seq`` (:func:`twin_value`,
:func:`twin_value_and_grad`): the redesign's bitwise reference, for checks
only; the dispatch never calls them.

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

from .. import eager, logic, optimize
from . import _build, cull_tables
from .power_map_kernel import (  # noqa: F401 (the rejection's names are this module's too)
    _REJECT_SLACK,
    GATE_EXIT,
    REJECT_MIN_DEN,
    SIGMOID_SAT,
    SIGMOID_VAG_FLOOR,
    SIGMOID_VALUE_FLOOR,
    _band_fails,
    _bounds,
    _check,
    _device_kind,
    _host_float,
    _soft_mode,
    cached_inputs,
    eager_backward,
    eager_jvp,
    rejection_bounds,
    rejects,
    request_tensors,
    save_inputs,
    tracked_scalars,
)

SOURCE = "power_map_looped.cu"
MAX_ORDER = 4
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
"""Sub-boxes per tile side in :func:`cull_tables.beam_keep_tables` for
requests of at most 1000 candidates (:func:`refine_for`).  Chosen with
:data:`TILE` on the order-1 city map: refine 4 built its tables in about
half the time of refine 8, and the culled kernel ran as fast (the extra
candidates it keeps are a fraction of a percent of the work); 16 doubles
the build again."""
REFINE_LARGE = 1
"""The same above 1000 candidates, chosen on the order-2 city map (18,496
candidates, 1024 x 1024, 16 x 16 tiles, :mod:`.looped_tuning`): the build
grows with the square of the refine (60 ms at 1, 143 ms at 2, 0.51 s at 4,
2.0 s at 8, 7.8 s at 16 on an H100) while the culled value kernel gains
under 4% (27.1 ms at 1, 25.7 ms at 8: the finer proofs keep 0.51% against
0.54% of the order-2 candidate-pixels)."""


def refine_for(num_candidates: int) -> int:
    """Refine of the beam proof for a request of ``num_candidates``
    candidates (orders >= 1), keyed on the count as the JAX package keys
    its own (8 or 16, tuned on a TPU)."""
    return REFINE if num_candidates <= 1000 else REFINE_LARGE


LAUNCHES = {"power_map_looped_value": 0, "power_map_looped_vag": 0}
"""Launches of each kernel since the process started (or was reset)."""
TWIN_LAUNCHES = {"power_map_looped_value_seq": 0, "power_map_looped_vag_seq": 0}
"""Launches of the sequential-sweep twins (:func:`twin_value`,
:func:`twin_value_and_grad`), which only checks call."""

_SIGMOID_SATURATES: dict = {}
_SIGMOID_BANDS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in TWIN_LAUNCHES:
        TWIN_LAUNCHES[name] = 0


def kernel_caps_reason(num_walls: int, max_order: int) -> Optional[str]:
    """Why the looped kernels cannot take this request, or None."""
    if num_walls > MAX_WALLS:
        return f"the looped CUDA kernels hold at most {MAX_WALLS} objects, got {num_walls}"
    if max_order > MAX_ORDER:
        return f"the looped CUDA kernels take orders <= {MAX_ORDER}, got {max_order}"
    return None


@dataclasses.dataclass(frozen=True)
class LoopedInputs:
    """Device inputs derived from a candidate set of orders <= :data:`MAX_ORDER`.

    ``cands`` holds one ``(order, int32[C_o, order])`` pair per order >= 1
    with candidates, in ascending order (the kernels' candidate groups, each
    row the walls of one candidate); ``groups`` the host candidate matrices;
    ``eager`` the same set for the plain versions and the backward.
    """

    cands: tuple
    has_los: bool
    groups: dict
    eager: eager.EagerSpec

    @property
    def orders(self) -> tuple:
        return tuple(o for o, _ in self.cands)

    @property
    def max_order(self) -> int:
        return max(self.orders, default=0)

    @property
    def num_candidates(self) -> int:
        """Candidates of orders >= 1 (the line of sight is not listed)."""
        return sum(int(c.shape[0]) for _, c in self.cands)


def looped_inputs(groups: dict, device, *, approx: bool, sigmoid: bool) -> LoopedInputs:
    """Cached :class:`LoopedInputs` (``power_map_kernel.cached_inputs``)."""
    if any(o > MAX_ORDER and g.shape[0] for o, g in groups.items()):
        msg = f"the looped kernels take orders <= {MAX_ORDER}, got {sorted(groups)}"
        raise ValueError(msg)

    def make():
        cands = tuple(
            (o, torch.from_numpy(np.array(g, dtype=np.int32).reshape(-1, o)).to(device))
            for o, g in sorted(groups.items()) if o >= 1 and g.shape[0]
        )
        return LoopedInputs(
            cands=cands,
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
    per candidate group of :attr:`LoopedInputs.cands`, ``prm[k] int32[T,
    C_o]`` and ``cnt[k] int32[T]``; ``l0w int32[W, NW]``, ``lastw int32[T,
    W, NW]``, ``losw int32[T, NW]`` and, with middle segments (order >= 2),
    ``midw int32[W * W, NW]`` (else ``[0, NW]``); ``order int32[T]``, the
    tiles by descending blocked-test count (:func:`tile_order`), the order
    in which the kernels' persistent blocks take them."""

    prm: tuple
    cnt: tuple
    l0w: torch.Tensor
    lastw: torch.Tensor
    losw: torch.Tensor
    midw: torch.Tensor
    order: torch.Tensor

    @property
    def tensors(self) -> tuple:
        return (*self.prm, *self.cnt, self.l0w, self.lastw, self.losw, self.midw, self.order)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)


@dataclasses.dataclass(frozen=True)
class TxPlan:
    """One transmitter's launch: its position ``tx[2]``, the walls' unit
    normals and patched endpoints ``aux[W, 6]``, per candidate group the
    mirror-image chains ``imgs[k] float32[C_o, o, 2]``, and the tables."""

    tx: torch.Tensor
    aux: torch.Tensor
    imgs: tuple
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
    """``(normals[W, 2], aux[W, 6], imgs)``: unit normals, normals and
    patched endpoints as the kernels read them, and per candidate group the
    transmitter's mirror-image chain through the candidate's walls,
    ``float32[C_o, o, 2]`` (the formulas of ``pallas_kernels.py:3251-3281``;
    a vertex, whose normal is 0, mirrors nothing)."""
    a, b = walls[:, 0, :], walls[:, 1, :]
    t_vec = b - a
    n_raw = torch.stack([t_vec[:, 1], -t_vec[:, 0]], dim=-1)
    n_len = torch.sqrt(cull_tables._sum2(n_raw * n_raw))[:, None]
    normals = n_raw / torch.where(n_len == 0.0, torch.ones_like(n_len), n_len)
    patch_t = torch.as_tensor(patch, dtype=torch.float32, device=walls.device)
    aux = torch.cat([normals, a - patch_t * t_vec, b + patch_t * t_vec], dim=-1)
    imgs = []
    for o, cand in inputs.cands:
        cur = tx[None, :].expand(cand.shape[0], 2)
        chain = []
        for j in range(o):
            idx = cand[:, j].long()
            wn, wa = normals[idx], walls[idx, 0, :]
            d = cull_tables._sum2((cur - wa) * wn)[:, None]
            cur = cur - 2.0 * d * wn
            chain.append(cur)
        imgs.append(torch.stack(chain, dim=1).contiguous())
    return normals, aux.contiguous(), tuple(imgs)


# Elements of one slab of the last-segment masks ([tiles, W, W] bools).
_LAST_SLAB = 1 << 25


def build_tables(walls, kind, tx, normals, imgs, inputs: LoopedInputs, bounds,
                 scalars, *, approx: bool, sigmoid: bool, cull: bool, shadow: bool) -> Tables:
    """The kernels' tables for one transmitter: the beam proof's kept
    candidates of each group (``cull``) and the occluder bit words
    (``shadow``).  Where a flag is off its tables are identity tables:
    every candidate in every tile, every wall on every list."""
    alpha, tol, patch = scalars[0], scalars[1], scalars[2]
    x0, x1, y0, y1 = bounds
    T, W, dev = x0.shape[0], walls.shape[0], walls.device
    nw = -(-W // 32)
    mid_rows = W * W if inputs.max_order >= 2 else 0
    every_wall = cull_tables.pack_words(torch.ones(W, dtype=torch.bool, device=dev))
    if cull and inputs.cands:
        keep = cull_tables.beam_keep_tables(
            walls, normals, kind, inputs.groups, inputs.orders, dict(zip(inputs.orders, imgs)),
            x0, x1, y0, y1, approx=approx, alpha=alpha, tx=tx, patch=patch,
            refine=refine_for(inputs.num_candidates), sigmoid=sigmoid, tol=tol,
        )
        lists = [cull_tables.keep_lists(keep[o]) for o in inputs.orders]
    else:
        lists = [(torch.arange(c.shape[0], dtype=torch.int32, device=dev)
                  .expand(T, c.shape[0]).contiguous(),
                  torch.full((T,), c.shape[0], dtype=torch.int32, device=dev))
                 for _, c in inputs.cands]
    if shadow:
        geo = cull_tables._shadow_geometry(walls, kind, tx, patch, alpha, approx, sigmoid, tol)
        step = max(1, _LAST_SLAB // max(W * W, 1))
        lastw = torch.cat([
            cull_tables.pack_words(cull_tables.last_masks(
                geo, x0[s:s + step], x1[s:s + step], y0[s:s + step], y1[s:s + step]))
            for s in range(0, T, step)
        ])
        l0w = cull_tables.pack_words(cull_tables.first_masks(geo, tx))
        # The un == 0 hazard gate: every wall on the first and last lists
        # (mid_words applies it itself).
        l0w = torch.where(geo["hz_free"], l0w, every_wall)
        lastw = torch.where(geo["hz_free"], lastw, every_wall)
        losw = cull_tables.pack_words(cull_tables.los_masks(geo, tx, x0, x1, y0, y1))
        midw = cull_tables.mid_words(geo) if mid_rows else every_wall.expand(0, nw)
    else:
        l0w = every_wall.expand(W, nw)
        lastw = every_wall.expand(T, W, nw)
        losw = every_wall.expand(T, nw)
        midw = every_wall.expand(mid_rows, nw)
    tables = Tables(prm=tuple(p for p, _ in lists), cnt=tuple(c for _, c in lists),
                    l0w=l0w.contiguous(), lastw=lastw.contiguous(), losw=losw.contiguous(),
                    midw=midw.contiguous(), order=torch.empty(0, dtype=torch.int32, device=dev))
    order = tile_order(tile_tests(tables, inputs, kind))
    return dataclasses.replace(tables, order=order)


# Elements of one slab of the per-tile gathers of :func:`tile_tests`.
_TESTS_SLAB = 1 << 24


def tile_tests(tables: Tables, inputs: LoopedInputs, kind: torch.Tensor) -> torch.Tensor:
    """``int64[T]``: the blocked tests each tile's kept candidates run
    through the occluder words (listed, non-vertex walls other than the
    segment's own), the line of sight included; one reduction over the kept
    lists and the words' popcounts."""
    W = kind.shape[0]
    dev = tables.losw.device
    T = tables.losw.shape[0]
    solid = (kind.to(dev) != 2)
    other = ~torch.eye(W, dtype=torch.bool, device=dev)
    unpack = cull_tables.unpack_words
    l0c = (unpack(tables.l0w, W) & solid & other).sum(-1)
    lastc = (unpack(tables.lastw, W) & solid & other).sum(-1)  # [T, W]
    midc = None
    if tables.midw.numel():
        m = unpack(tables.midw, W).reshape(W, W, W) & solid
        midc = (m & other[:, None, :] & other[None, :, :]).sum(-1)
    tests = torch.zeros(T, dtype=torch.int64, device=dev)
    if inputs.has_los:
        tests += (unpack(tables.losw, W) & solid).sum(-1)
    for (o, cand), prm, cnt in zip(inputs.cands, tables.prm, tables.cnt):
        w = cand.long()
        head = l0c[w[:, 0]]
        for k in range(1, o):
            head = head + midc[w[:, k - 1], w[:, k]]
        width = int(cnt.max()) if T else 0
        if width == 0:
            continue
        rank = torch.arange(width, device=dev)
        step = max(1, _TESTS_SLAB // width)
        for t0 in range(0, T, step):
            ts = slice(t0, t0 + step)
            p = prm[ts, :width].long()
            kept = rank[None, :] < cnt[ts, None]
            per = head[p] + lastc[ts].gather(1, w[p, -1])
            tests[ts] += torch.where(kept, per, torch.zeros_like(per)).sum(-1)
    return tests


def tile_order(tests: torch.Tensor) -> torch.Tensor:
    """``int32[T]``: the tiles by descending ``tests``, ties in index order
    (longest first: the last blocks to start are the shortest)."""
    return torch.argsort(tests, descending=True, stable=True).to(torch.int32).contiguous()


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
            normals, aux, imgs = launch_constants(walls, tx, host[2], inputs)
            tables = build_tables(walls, kind, tx, normals, imgs, inputs, bounds, host,
                                  approx=approx, sigmoid=sigmoid, cull=cull,
                                  shadow=shadow)
            per_tx.append(TxPlan(tx=tx.contiguous(), aux=aux, imgs=imgs, tables=tables))
    return optimize.constants(
        Plan(rows=X.shape[0], cols=X.shape[1], tile=tuple(tile), per_tx=tuple(per_tx)))


# -- plain versions ---------------------------------------------------------------


def _keep_mask(prm: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``keep[T, C]`` bool from one group's kept-first lists."""
    T, C = prm.shape
    rank = torch.arange(C, device=cnt.device)[None, :].expand(T, C)
    keep = torch.zeros(T, C, dtype=torch.bool, device=cnt.device)
    return keep.scatter(1, prm.long(), rank < cnt[:, None].long())


@dataclasses.dataclass(frozen=True)
class _Masks:
    """One transmitter's tables as masks: ``keep`` per order, ``los[T, W]``,
    ``last[T, W, W]`` and, per order, the occluders of the segments before
    the last, ``head[o] bool[C_o, o, W]``."""

    keep: dict
    los: torch.Tensor
    last: torch.Tensor
    head: dict


def _plain_masks(plan: Plan, W: int, inputs: LoopedInputs) -> list:
    """Each transmitter's :class:`_Masks`."""
    out = []
    for tp in plan.per_tx:
        tb = tp.tables
        l0 = cull_tables.unpack_words(tb.l0w, W)
        mid = cull_tables.unpack_words(tb.midw, W).reshape(-1, W, W) if tb.midw.numel() else None
        head = {}
        for o, cand in inputs.cands:
            w = cand.long()
            segs = [l0[w[:, 0]]] + [mid[w[:, s - 1], w[:, s]] for s in range(1, o)]
            head[o] = torch.stack(segs, dim=1)
        out.append(_Masks(
            keep={o: _keep_mask(p, c) for o, p, c in zip(inputs.orders, tb.prm, tb.cnt)},
            los=cull_tables.unpack_words(tb.losw, W),
            last=cull_tables.unpack_words(tb.lastw, W), head=head))
    return out


def _plain_chunk(p, flat, walls, kind, phi, scalars, inputs: LoopedInputs, plan: Plan,
                 masks):
    """Map of one pixel chunk (``p[n, 2]`` at flat indices ``flat[n]``),
    summed over the transmitters; differentiable in ``p``."""
    alpha, tol, patch, r_coef, height = scalars
    arrays = eager.SceneArrays(walls=walls, kind=kind, phi=phi)
    spec = inputs.eager
    tile = plan.tile_of(flat)
    rx = p.reshape(-1, 1, 2)
    n = p.shape[0]
    out = None
    for tp, m in zip(plan.per_tx, masks):
        tx = tp.tx.reshape(1, 1, 2)
        acc = torch.zeros(n, device=p.device)
        for order, cand in spec.groups:
            if cand.shape[0] == 0:
                continue
            if order == 0:
                listed = m.los[tile][:, None, None, :]
            else:
                last = m.last[tile][:, cand[:, -1]][:, :, None, :]
                head = m.head[order][None].expand(n, -1, -1, -1)
                listed = torch.cat([head, last], dim=2)
            pts_full, _, valid = eager._trace_group(
                tx, rx, arrays, order, cand, approx=spec.approx, alpha=alpha,
                function=spec.function, tol=tol, patch=patch, listed=listed,
            )
            c = valid * eager._received_power_batched(pts_full, order, r_coef, height)
            if order >= 1:
                c = torch.where(m.keep[order][tile], c, torch.zeros_like(c))
            acc = acc + torch.sum(c, dim=-1)
        out = acc if out is None else out + acc
    return torch.zeros(n, device=p.device) if out is None else out


def plain_looped_value(px, py, walls, kind, phi, scalars, inputs: LoopedInputs,
                       plan: Plan) -> torch.Tensor:
    """Plain PyTorch version of ``power_map_looped_value``: ``[P]``."""
    pixels = torch.stack([px, py], dim=-1)
    masks = _plain_masks(plan, walls.shape[0], inputs)
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
    masks = _plain_masks(plan, walls.shape[0], inputs)
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
    common = [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
              _P, _P, _P, _P, _P, _P, _F, _F, _F, _I, _F, _F, _F, _F, _F, _I]
    for name in ("power_map_looped_value", "power_map_looped_value_seq"):
        getattr(lib, name).argtypes = [*common, _P, _P]
        getattr(lib, name).restype = _I
    for name in ("power_map_looped_vag", "power_map_looped_vag_seq"):
        getattr(lib, name).argtypes = [*common, _P, _P, _P]
        getattr(lib, name).restype = _I
    lib.sigmoid_band_probe.argtypes = [_F, _I, _P, _P]
    lib.sigmoid_band_probe.restype = _I


def load_library() -> ctypes.CDLL:
    """The kernels' library, built from ``csrc/power_map_looped.cu`` on first use."""
    return _build.load(SOURCE, _declare)


def _check_inputs(px, py, walls, kind, phi, inputs: LoopedInputs, plan: Plan) -> None:
    cap = kernel_caps_reason(walls.shape[0], inputs.max_order)
    if cap is not None:
        raise ValueError(cap)
    dev = px.device
    named = [("px", px, torch.float32), ("py", py, torch.float32),
             ("walls", walls, torch.float32), ("kind", kind, torch.int32),
             ("phi", phi, torch.float32)]
    named += [(f"cand[order {o}]", c, torch.int32) for o, c in inputs.cands]
    for t, tp in enumerate(plan.per_tx):
        named += [(f"tx[{t}]", tp.tx, torch.float32), ("aux", tp.aux, torch.float32)]
        named += [(f"imgs[{k}]", im, torch.float32) for k, im in enumerate(tp.imgs)]
        named += [(f"tables[{k}]", tt, torch.int32) for k, tt in enumerate(tp.tables.tensors)]
    for name, t, dtype in named:
        if t.device != dev:
            msg = f"{name} is on {t.device}, expected {dev}"
            raise ValueError(msg)
        if t.dtype != dtype or not t.is_contiguous():
            msg = f"{name} must be contiguous {dtype}, got {t.dtype}"
            raise ValueError(msg)
    P, W = px.numel(), walls.shape[0]
    T, nw = plan.tiles[0] * plan.tiles[1], -(-W // 32)
    if py.numel() != P or P != plan.rows * plan.cols or tuple(walls.shape[1:]) != (2, 2):
        msg = "bad shapes: px/py [rows * cols], walls [W, 2, 2]"
        raise ValueError(msg)
    if P >= 2**31:
        msg = f"the kernels take P < 2**31 pixels, got {P}"
        raise ValueError(msg)
    sizes = [int(c.shape[0]) for _, c in inputs.cands]
    for tp in plan.per_tx:
        tb = tp.tables
        if (len(tb.prm) != len(sizes) or len(tp.imgs) != len(sizes)
                or any(tuple(p.shape) != (T, C) for p, C in zip(tb.prm, sizes))
                or any(tuple(c.shape) != (T,) for c in tb.cnt)
                or any(tuple(im.shape) != (C, o, 2) for im, C, o in
                       zip(tp.imgs, sizes, inputs.orders))
                or tuple(tb.l0w.shape) != (W, nw) or tuple(tb.lastw.shape) != (T, W, nw)
                or tuple(tb.losw.shape) != (T, nw) or tuple(tb.order.shape) != (T,)
                or tuple(tb.midw.shape) != (W * W if inputs.max_order >= 2 else 0, nw)
                or tuple(tp.aux.shape) != (W, 6)):
            msg = f"tables do not fit {T} tiles, candidate groups {sizes} and {W} walls"
            raise ValueError(msg)


def _groups_args(inputs: LoopedInputs, tp: TxPlan):
    """The candidate groups as the C functions take them: per order 1 to
    MAX_ORDER the pointers to its candidates, images, kept lists and counts
    (0 for an order without candidates), and the counts of candidates."""
    ptrs = (_P * (4 * MAX_ORDER))()
    sizes = (_I * MAX_ORDER)()
    for (o, cand), img, prm, cnt in zip(inputs.cands, tp.imgs, tp.tables.prm, tp.tables.cnt):
        for k, t in enumerate((cand, img, prm, cnt)):
            ptrs[k * MAX_ORDER + o - 1] = t.data_ptr()
        sizes[o - 1] = int(cand.shape[0])
    return ptrs, sizes


ABLATIONS = ("rejection", "saturation", "gate", "order")
"""Parts of the redesigned sweep that :func:`_launch` can switch off, for
measuring each one's share only (``looped_tuning --census``): the
rejection (bounds at -inf / inf), the saturation exits (``sat`` at inf),
the gate
exits (``features`` 0) and the longest-first order (tiles in grid order).
Each keeps every output bit, as the proofs in the source say."""


def _launch(name, px, py, walls, kind, phi, scalars, inputs, plan, approx, sigmoid,
            out, gout=None, counts=LAUNCHES, ablate=()):
    _check_inputs(px, py, walls, kind, phi, inputs, plan)
    if px.numel() == 0:
        return
    lib = load_library()
    fn = getattr(lib, name)
    host = [_host_float(v) for v in scalars]
    mode = _soft_mode(approx, sigmoid)
    tlo, thi, sat = _bounds(host[0], mode, gout is not None,
                            bool(not sigmoid or sigmoid_bands(px.device)))
    inf = float("inf")
    if "rejection" in ablate:
        tlo, thi = -inf, inf
    if "saturation" in ablate:
        sat = inf
    features = 0 if "gate" in ablate else GATE_EXIT
    grid_order = None
    if "order" in ablate:
        grid_order = torch.arange(plan.tiles[0] * plan.tiles[1], dtype=torch.int32,
                                  device=px.device)
    counter = torch.empty(1, dtype=torch.int32, device=px.device)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        for t, tp in enumerate(plan.per_tx):
            tb = tp.tables
            ptrs, sizes = _groups_args(inputs, tp)
            args = [
                mode, px.data_ptr(), py.data_ptr(), plan.rows,
                plan.cols, plan.tile[0], plan.tile[1], tp.tx.data_ptr(), walls.data_ptr(),
                tp.aux.data_ptr(), kind.data_ptr(), phi.data_ptr(), walls.shape[0],
                int(inputs.has_los), inputs.max_order, ptrs, sizes, tb.l0w.data_ptr(),
                tb.lastw.data_ptr(), tb.losw.data_ptr(), tb.midw.data_ptr(),
                (tb.order if grid_order is None else grid_order).data_ptr(),
                counter.data_ptr(), tlo, thi, sat, features, *host,
                int(t > 0), out.data_ptr(),
            ]
            if gout is not None:
                args.append(gout.data_ptr())
            _check(fn(*args, stream), name)
            counts[name] += 1


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


def twin_value(px, py, walls, kind, phi, scalars, inputs: LoopedInputs, plan: Plan, *,
               approx: bool, sigmoid: bool) -> torch.Tensor:
    """:func:`value` through ``power_map_looped_value_seq``, the sequential
    sweep that the redesigned kernel must equal bit for bit (CUDA tensors;
    the plain version on the CPU).  For checks only: the dispatch never
    calls it."""
    if _device_kind(px, "power_map_looped_value_seq") == "cpu":
        return plain_looped_value(px, py, walls, kind, phi, scalars, inputs, plan)
    out = torch.zeros_like(px)
    _launch("power_map_looped_value_seq", px, py, walls, kind, phi, scalars, inputs, plan,
            approx, sigmoid, out, counts=TWIN_LAUNCHES)
    return out


def twin_value_and_grad(px, py, walls, kind, phi, scalars, inputs: LoopedInputs,
                        plan: Plan, *, approx: bool, sigmoid: bool):
    """:func:`value_and_grad` through ``power_map_looped_vag_seq`` (see
    :func:`twin_value`)."""
    if _device_kind(px, "power_map_looped_vag_seq") == "cpu":
        return plain_looped_value_and_grad(px, py, walls, kind, phi, scalars, inputs, plan)
    out = torch.zeros_like(px)
    gout = torch.zeros(px.numel(), 2, dtype=px.dtype, device=px.device)
    _launch("power_map_looped_vag_seq", px, py, walls, kind, phi, scalars, inputs, plan,
            approx, sigmoid, out, gout, counts=TWIN_LAUNCHES)
    return out, gout


class LoopedMapFunction(torch.autograd.Function):
    """Value map: the looped kernel forward, the plain tracer's derivatives
    (VJP backward, JVP forward mode; unculled: the tables only drop exact
    zeros)."""

    @staticmethod
    def forward(px, py, txs, walls, phi, scal, kind, host_scalars, inputs, plan, approx,
                sigmoid):
        return value(px, py, walls, kind, phi, host_scalars, inputs, plan,
                     approx=approx, sigmoid=sigmoid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        save_inputs(ctx, inputs)

    @staticmethod
    def backward(ctx, g):
        return (*eager_backward(ctx, g), None, None, None, None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        return eager_jvp(ctx, tangents)


def sigmoid_saturates(device) -> bool:
    """Whether the sigmoid that maps on ``device`` run through is exactly 0
    at ``-(Z0 - 1)`` and exactly 1 at ``Z1 - 1`` (``cull_tables._SIGMOID_Z0``
    and ``_SIGMOID_Z1``), as sigmoid culling needs: on a GPU the kernels'
    own ``1 / (1 + expf(-z))``, for every float32 at and past those points
    (the bands of :func:`sigmoid_bands` at :data:`SIGMOID_VAG_FLOOR` and
    :data:`SIGMOID_SAT`, which are those points); on the CPU the plain
    version's at the two points.  Checked once per device."""
    dev = torch.device(device)
    key = str(dev)
    hit = _SIGMOID_SATURATES.get(key)
    if hit is None:
        if dev.type == "cuda":
            fails = _sigmoid_band_fails(dev)
            hit = fails[1] == 0 and fails[2] == 0
        else:
            z = torch.tensor([-(cull_tables._SIGMOID_Z0 - 1.0),
                              cull_tables._SIGMOID_Z1 - 1.0], dtype=torch.float32)
            lo, hi = logic.sigmoid(z, 1.0).tolist()
            hit = lo == 0.0 and hi == 1.0
        _SIGMOID_SATURATES[key] = hit
    return hit


def _sigmoid_band_fails(dev: torch.device) -> tuple:
    """Per band of :func:`sigmoid_bands`, the float32 values where the
    looped kernels' sigmoid on ``dev`` breaks it (``sigmoid_band_probe``,
    about 3e9 values in all, once per device)."""
    return _band_fails(_SIGMOID_BANDS, dev, lambda: load_library().sigmoid_band_probe)


def sigmoid_bands(device) -> bool:
    """Whether the kernels' sigmoid on ``device`` keeps the three bands the
    redesigned sweep relies on, for every float32 of each band:
    ``1 - clip(sigm(z), 0, 1) == 1`` for ``z <= SIGMOID_VALUE_FLOOR``,
    ``sigm(z) == 0`` for ``z <= SIGMOID_VAG_FLOOR`` and ``1 - clip(sigm(z),
    0, 1) == 0`` for ``z >= SIGMOID_SAT``.  Where they fail, sigmoid maps
    run without rejection and without the saturation exit
    (:func:`rejection_bounds`).  The CPU runs the plain version, which
    rejects nothing: True there."""
    dev = torch.device(device)
    return dev.type != "cuda" or not any(_sigmoid_band_fails(dev))


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
