#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. the card: name and power limit (``nvidia-smi``), TF32 off;
2. build the kernels from ``differt2d_tpu_torch/ops/csrc`` (one ``nvcc`` per
   source, all started together);
3. the main path: ``power_map`` of ``Scene.basic_scene()`` on a 1024 x 1024
   receiver grid (order <= 1, soft logic, hard_sigmoid, alpha 100), as a
   value map and as a value + pixel-gradient map, through the entry point a
   user calls; the launch counters are zeroed just before and read just
   after, and each kernel's output is held against its plain PyTorch
   version on the same inputs on the card (values at rtol 1e-4 / atol 1e-5,
   gradients under the kink contract at rtol 1e-3 / atol 1e-5);
4. coverage at 256 x 256: hard logic, the sigmoid activation, a square
   scene with a RIS and a vertex, two transmitters, transmitter grids and
   order 2, each against the plain version;
5. autograd through the value kernel: gradients of the map's sum with
   respect to the transmitter, the walls and alpha, against the plain
   version's autograd;
6. timing with CUDA events (32 maps chained without a host sync, median of
   5 repeats), each kernel's bound (the work these inputs need: the
   blocked tests of gate-live candidates, rejected ones at their cost, from
   a census of 32 tiles), and the plain version's time; the redesigned
   ``power_map_value`` and ``power_map_vag`` each timed against its
   sequential twin in turns (twin, new, new, twin), with their registers,
   blocks per SM, the instructions of one blocked test and of a rejected
   one (``sass_census``) and their issue-slot bounds; whether the card's
   sigmoid keeps the bands the rejection rests on;
7. the city path: ``power_map`` of ``Scene.city_extract_scene()`` (136
   walls, order <= 1, soft logic, alpha 100) on a 1024 x 1024 grid, value
   and value + gradient, through the looped kernels with their culling
   tables; the looped launch counters are zeroed just before and read just
   after, and the path must run no unrolled kernel and no eager tracer;
   the culled maps must equal the identity-table maps of the same build bit
   for bit, and the kernels are held against their plain versions on the
   same 1024 x 1024 inputs, and again on a 256 x 256 map (cfg6/cfg7's size);
   each plain call is timed once;
8. coverage at 256 x 256, each against the plain version and bit for bit
   against identity tables: ``city_scene``, hard logic, sigmoid (with the
   card's saturation check printed), two transmitters, a transmitter grid,
   a RIS and a vertex;
9. autograd through the looped value kernel at 64 x 64 (walls, transmitter,
   alpha) against the plain version's;
10. timing at 1024 x 1024 and 256 x 256 (CUDA events, 8 maps chained,
    median of 5): culled kernel, identity-table kernel, table build, end to
    end, beside the plain version's time from phase 7; both bounds (the
    unculled map's operations and those the tables leave) with the kept
    shares;
11. the solver path: ``power_map`` of the RIS map of
    ``examples/plot_ris_power_map.py`` (``Scene.square_scene()`` with a RIS
    at phi = pi/4, order 1, MPT, 1000 adam steps, soft logic, key
    ``PRNGKey(1234)``, RIS-only candidates) on a 1024 x 1024 grid, and the
    wall solves of ``square_scene`` (Fermat and MPT, 100 steps; Fermat
    again with orders 0 and 1, whose line-of-sight group runs the unrolled
    value kernel); the solver and unrolled launch counters are zeroed just
    before each map and read just after, and the solver kernel must have
    run in each (the unrolled one for the line of sight); each kernel is
    held against its plain version (the eager solve) on the same 1024 x 1024
    inputs: Fermat at rtol 1e-3 / atol 1e-4, MPT under the flip contract
    (at most 0.5% of pixels beyond 0.05 (1 + |ref|), the others within 1e-3
    relative), each plain call timed once; for the map with the line of
    sight, the unrolled kernel against its plain version on that group's
    inputs, and the whole map against the eager map of the whole request;
12. coverage at 256 x 256 through ``power_map`` against the eager route:
    hard logic, the sigmoid with the line of sight, two transmitters and a
    transmitter grid;
13. autograd through ``SolverMapFunction``: the gradient of the sum of a
    64 x 64 RIS map (100 steps) with respect to the RIS phase against the
    eager solver's;
14. timing at 1024 x 1024 (CUDA events, 8 maps chained, median of 5): the
    solver kernel against its sequential twin in turns and ``power_map``
    end to end for each map of phase 11, with the bound from the operations
    the solve needs, the registers, blocks per SM, one adam step's
    instructions and the issue-slot bound of both kernels;
15. the order-2 city path: ``power_map`` of ``Scene.city_extract_scene()``
    with ``max_order=2`` (18,497 candidates, soft logic, alpha 100) on a
    1024 x 1024 grid, value and value + gradient, through the looped
    kernels with middle-segment words and pair kills; the looped launch
    counters are zeroed just before and read just after, and the unrolled
    and solver counters and the eager tracer must not move; the culled value
    map must equal the identity-table map bit for bit (one unculled call),
    and at 256 x 256 (cfg8's size) the value and value + gradient maps; the
    kernels are held against their plain versions on four 16 x 16 tiles of
    the 1024 x 1024 map with those tiles' own tables (the two with the most
    kept order-2 candidates, the transmitter's, a corner), each plain call
    timed once;
16. coverage at 32 x 32, each case bit for bit against identity tables and
    against the plain version on the block of the grid with the most
    nonzero pixels (16 x 16, or 8 x 8 or 2 x 2 where the plain version's
    work per pixel is large): hard logic, sigmoid,
    ``city_scene``, two transmitters, a seeded random city of 300 walls,
    the basic scene at order 2 (gradient map) and 3, and 6 buildings of the
    city extract at order 3;
17. autograd through the looped value kernel at order 2 and 32 x 32 (walls,
    transmitter, alpha) against the plain version's;
18. timing at 1024 x 1024 and 256 x 256 (CUDA events, maps chained, median
    of 5): culled kernels, table build, end to end, the bound of the work
    the tables leave, the kept share of each order's candidate-pixels and
    the listed share of the middle-segment words.

19. the redesigned looped kernels against their sequential twins
    (``power_map_looped_value_seq``/``_vag_seq``: the same source with the
    redesign off), ``torch.equal`` on value and gradient, for the 1024 x
    1024 order-2 and order-1 city maps, the 256 x 256 order-1 map and, at
    32 x 32, every phase-16 case, a RIS with a vertex and a duplicated wall;
    and whether the card's sigmoid keeps the bands the redesign relies on.
20. the redesigned ``opt_solver_value``, ``power_map_vag`` and
    ``power_map_value`` against their sequential twins
    (``opt_solver_value_seq``, ``power_map_vag_seq``,
    ``power_map_value_seq``: the same sources with the redesign off),
    ``torch.equal``: the 1024 x 1024 RIS map and wall solves, the phase-12
    cases at 256 x 256, a RIS with a vertex and a zero-length wall on a
    pixel; the 1024 x 1024 basic-scene gradient and value maps, the
    phase-4 cases at 256 x 256, a duplicated wall and walls short enough
    for blocked tests with |den| below 2^-90; for the value kernel also the
    24-wall slice of ``city_scene`` (stream proxy 1,176, the top of its
    route) and phase 11's line-of-sight group, at 1024 x 1024.
21. ``power_map_value`` against its twin in turns on that line-of-sight
    group, the 24-wall slice and the basic scene at order 2 (1024 x 1024);
    and the router record: on slices of ``city_scene`` and the basic scene
    at order 2, whose stream proxies bracket 400 and 1,200, the unrolled
    kernels against the looped route (kernel alone, and table build plus
    kernel), value and value + gradient, each pair held against each other.

    Phases 10 and 18 time each looped kernel against its twin in turns
    (twin, new, new, twin) and bound it by the work these inputs need
    (``needed_ops``) beside the count of every listed test.

The profile of one city map and the tile / refine sweeps that chose the
culling constants are in ``differt2d_tpu_torch/ops/looped_tuning.py``.
Each group of phases prints its seconds, and each of phases 15-18 its own.

It prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line,
and, last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
REPLACES = "differt2d_tpu/ops/pallas_kernels.py:362"
SOURCE = "differt2d_tpu_torch/ops/csrc/power_map.cu"
LOOPED_REPLACES = "differt2d_tpu/ops/pallas_kernels.py:2234"
LOOPED_SOURCE = "differt2d_tpu_torch/ops/csrc/power_map_looped.cu"
SOLVER_REPLACES = "differt2d_tpu/ops/pallas_solver.py:55"
SOLVER_SOURCE = "differt2d_tpu_torch/ops/csrc/opt_solver.cu"
SOURCES = ("power_map.cu", "power_map_looped.cu", "opt_solver.cu")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def import_port() -> None:
    """Import the package of this checkout (never one installed elsewhere)."""
    sys.path.insert(0, ROOT)
    try:
        import differt2d_tpu_torch
    except ImportError as exc:
        fail(f"differt2d_tpu_torch not found beside chip_smoke.py ({exc})")
    pkg_dir = os.path.dirname(os.path.abspath(differt2d_tpu_torch.__file__))
    check(pkg_dir == os.path.join(ROOT, "differt2d_tpu_torch"),
          f"imported differt2d_tpu_torch from {pkg_dir}, not this checkout")


def grid(n: int, device):
    import torch

    x = torch.linspace(0.01, 0.99, n, device=device)
    y = torch.linspace(0.012, 0.988, n, device=device)
    return torch.meshgrid(x, y, indexing="xy")


def max_abs(a, b) -> float:
    return float((a - b).abs().max().detach())


def assert_close(name, got, ref, tol=VALUE_TOL) -> float:
    import torch

    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    ok = torch.allclose(got, ref, **tol)
    err = max_abs(got, ref)
    # Worst ratio of error to allowance: under 1 passes.
    worst = float(((got - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().detach())
    check(ok, f"{name}: max abs err {err} beyond {tol} (worst ratio {worst:.3g})")
    print(f"  {name}: max abs err {err:.3g}, worst err/allowance {worst:.3g}", flush=True)
    return err


def assert_kinks(name, got, ref) -> float:
    import torch

    from differt2d_tpu_torch.utils import kink_excess

    check(bool(torch.isfinite(got).all()), f"{name}: non-finite gradients")
    n_bad, allowed = kink_excess(got, ref, **GRAD_TOL)
    check(n_bad <= allowed, f"{name}: {n_bad} gradient elements beyond kink allowance {allowed}")
    # Where there are kink elements the largest error is one of them: say
    # how large the others are.
    diff = (got - ref).abs().reshape(-1)
    kink = diff > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * ref.abs().reshape(-1)
    rest = float(diff[~kink].max()) if bool((~kink).any()) else 0.0
    at = int(diff.argmax())
    print(f"  {name}: {n_bad} kink elements (allowed {allowed:.0f}); max abs err {rest:.3g}"
          f" elsewhere; largest: kernel {float(got.reshape(-1)[at]):.6g},"
          f" plain {float(ref.reshape(-1)[at]):.6g}", flush=True)
    return float(diff[at])


def kink_probe(name, scene, X, Y, kw, got, ref) -> None:
    """Print where a gradient map's largest error lies: the pixel, both
    gradients there, and one-sided difference quotients of the kernel's
    value map along that axis, from ``power_map`` on three points."""
    import torch

    from differt2d_tpu_torch import power_map

    at = int((got - ref).abs().reshape(-1).argmax())
    pix, axis = divmod(at, 2)
    cols = X.shape[1]
    x, y = X.reshape(-1)[pix], Y.reshape(-1)[pix]
    quotients = []
    for h in (1e-3, 1e-5):
        step = torch.tensor([-h, 0.0, h], device=X.device)
        px = (x + step * (axis == 0))[None]
        py = (y + step * (axis == 1))[None]
        z = power_map(scene, px, py, **kw)[0]
        p = (px if axis == 0 else py)[0]
        quotients.append(f"h={h:g}: {float((z[1] - z[0]) / (p[1] - p[0])):.6g},"
                         f" {float((z[2] - z[1]) / (p[2] - p[1])):.6g}")
    print(f"  {name}: largest error at pixel (row {pix // cols}, column {pix % cols}),"
          f" x={float(x):.8g}, y={float(y):.8g}, d/d{'xy'[axis]}: kernel"
          f" {float(got.reshape(-1)[at]):.6g}, plain {float(ref.reshape(-1)[at]):.6g};"
          f" the kernel's value map's one-sided quotients (left, right) "
          + "; ".join(quotients), flush=True)


def timed(fn):
    """``(fn(), ms)``: one call, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_time_ms(fn, k: int, reps: int) -> float:
    """Median over ``reps`` of the mean ms per call of ``k`` chained calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


# Operations the main path's map needs (soft logic, hard_sigmoid), counted
# by hand: one per float add, sub, mul, div, sqrt or exp; selects, compares
# and min/max are free.  Each value is counted once, where it first depends
# on the pixel, whatever the kernel repeats: per-wall values (direction,
# unit normal, patched ends and their direction, a.n, 1/|b - a|^2, sin/cos
# of the RIS phase) and the transmitter's mirror images are formed once per
# launch, a segment's vector once per segment, and the blocked test takes
# the folded form of pallas_kernels._seg_intersect_m6 (z = num * (alpha /
# den), margins z + c1 and c2 - z with c1, c2 once per launch).  The
# gradient of a max or min needs the selected argument's partials only, so
# the blocked test's partials are counted once per candidate, not per wall.
OPS_PER_WALL = 22    # per launch: direction 2, |d|^2 3, sqrt and normal 3,
#                      1/|d|^2 1, a.n 3, patched ends 8, sin/cos 2
OPS_PER_IMAGE = 12   # per launch, transmitter and bounce: mirror 9, image.n 3
OPS_BOUNCE = 12      # backward image step: p.n 3, un 1, vn 1, vn/un 1, u 2, p + s u 4
OPS_SEGMENT = 8      # vector 2, length |v + eps| 6 (plus one add per extra segment)
OPS_LOSS = {0: 25, 1: 17}  # wall: two unit vectors 12, reflect 8, |e|^2 5;
#                            RIS: unit vector 6, sin/cos 6, |e|^2 5
OPS_ON = 9           # t = (p - a).d / |d|^2 6, two margins 3
OPS_GATE = 2         # loss gate margin (alpha tol + 3) - alpha loss
OPS_TEST = 18        # blocked test: a - c 2, num_a, num_b, den 9, alpha/den 1,
#                      z_a, z_b 2, four margins 4
OPS_VALID_POWER = 7  # folded validity 2, r^2 + h^2 and division 3, valid * power 1, sum 1
OPS_REJECT = 13      # a rejected test: a - c 2, num_a, num_b, den 9, |den| * bounds 2
# With the pixel gradient:
OPS_JACOBIAN = 12    # rank-1 bounce Jacobian: f 1, g 4, d - g n 4, scale 3
OPS_ON_GRAD = 2      # slope times the bounce's rank-1 gradient
OPS_LOSS_GRAD_RIS = 31  # 2e weights 8, rw 3, q 6, two contractions 10, sum 4
OPS_BLOCK_GRAD = 18  # selected wall's partials 14, times the slope 4
OPS_CONTRACT = 7     # per bounce end of that segment: k 3, two products 2, sum 2
OPS_POWER_GRAD = 15  # dP/dr 3, unit vector 2, products 2, value rule 6, sum 2


def cand_ops(row, kinds: tuple, with_grad: bool) -> tuple[int, int, int]:
    """``(operations besides the blocked tests, blocked tests, operations per
    launch and transmitter)`` of one candidate (its wall indices ``row``)
    when every segment is tested against every non-adjacent, non-vertex
    wall."""
    order = len(row)
    wall_kinds = [k for k in kinds if k != 2]
    bounces = [kinds[i] for i in row if kinds[i] != 2]
    ids = [-1, *row, -1]
    tested = sum(
        len(wall_kinds) - sum(1 for w in {ids[s], ids[s + 1]} if w >= 0 and kinds[w] != 2)
        for s in range(order + 1)
    )
    f = OPS_SEGMENT * (order + 1) + order + OPS_VALID_POWER
    f += sum(OPS_BOUNCE + OPS_LOSS[k] + OPS_ON for k in bounces)
    f += OPS_GATE if bounces else 0
    if with_grad:
        f += sum(OPS_JACOBIAN + OPS_ON_GRAD + (OPS_LOSS_GRAD_RIS if k == 1 else 0)
                 for k in bounces)
        f += OPS_BLOCK_GRAD + (OPS_CONTRACT if bounces else 0) + OPS_POWER_GRAD
    return f, tested, OPS_PER_IMAGE * len(bounces)


def ops_count(groups: dict, kinds: tuple, n_tx: int, with_grad: bool) -> tuple[int, int]:
    """``(per pixel, per launch)`` operations of the main path's map."""
    per_pixel, per_launch = 0, OPS_PER_WALL * len(kinds)
    for order, cands in groups.items():
        for row in cands:
            f, tested, img = cand_ops([int(i) for i in row], kinds, with_grad)
            per_pixel += f + OPS_TEST * tested
            per_launch += img * n_tx
    return per_pixel * n_tx + (n_tx - 1) * (3 if with_grad else 1), per_launch


def ops_left(plan, inputs, kinds: tuple, with_grad: bool) -> tuple[int, int, dict]:
    """``(operations, blocked tests, {order: kept candidate-pixels})`` that a
    looped map's tables leave, summed over its pixels and transmitters: each
    tile's kept candidates of each order, each segment tested against the
    walls its occluder words hold (less the walls adjacent to the segment
    and vertices, as the kernel skips them), plus the operations per
    launch."""
    import torch

    from differt2d_tpu_torch.ops.cull_tables import unpack_words
    from differt2d_tpu_torch.ops.power_map_looped import _keep_mask

    dev = plan.per_tx[0].aux.device
    W = len(kinds)
    solid = torch.tensor([k != 2 for k in kinds], device=dev)
    off_diag = ~torch.eye(W, dtype=torch.bool, device=dev)
    base = {o: torch.tensor([cand_ops(r, kinds, with_grad)[0] for r in cand.tolist()],
                            dtype=torch.float64, device=dev)
            for o, cand in inputs.cands}
    los_base = cand_ops([], kinds, with_grad)[0]
    tx, ty = plan.tiles
    cols = torch.arange(tx, device=dev)
    npix = ((torch.clamp(plan.cols - cols * plan.tile[0], max=plan.tile[0]))[None, :]
            * torch.clamp(plan.rows - torch.arange(ty, device=dev)[:, None] * plan.tile[1],
                          max=plan.tile[1])).reshape(-1).double()
    T = npix.shape[0]
    ops, tests, kept = 0.0, 0.0, {o: 0.0 for o in inputs.orders}
    for tp in plan.per_tx:
        tb = tp.tables
        l0 = (unpack_words(tb.l0w, W) & off_diag & solid).sum(-1).double()
        last = (unpack_words(tb.lastw, W) & off_diag & solid).sum(-1).double()  # [T, W]
        mid = None
        if tb.midw.numel():
            m = unpack_words(tb.midw, W).reshape(W, W, W) & solid & off_diag[:, None, :]
            mid = (m & off_diag[None, :, :]).sum(-1).double()  # [i, j]
        tile_tests = torch.zeros(T, dtype=torch.float64, device=dev)
        tile_ops = torch.zeros(T, dtype=torch.float64, device=dev)
        for (o, cand), prm, cnt in zip(inputs.cands, tb.prm, tb.cnt):
            w = cand.long()
            head = l0[w[:, 0]]
            for k in range(1, o):
                head = head + mid[w[:, k - 1], w[:, k]]
            keep = _keep_mask(prm, cnt)
            for t0 in range(0, T, 256):
                ts = slice(t0, t0 + 256)
                kf = keep[ts].double()
                seg = (kf * (head[None, :] + last[ts][:, w[:, -1]])).sum(-1)
                tile_tests[ts] += seg
                tile_ops[ts] += (kf * base[o][None, :]).sum(-1) + OPS_TEST * seg
            kept[o] += float((npix * cnt.double()).sum())
        if inputs.has_los:
            los = (unpack_words(tb.losw, W) & solid).sum(-1).double()
            tile_tests = tile_tests + los
            tile_ops = tile_ops + los_base + OPS_TEST * los
        ops += float((npix * tile_ops).sum())
        tests += float((npix * tile_tests).sum())
    n_tx = len(plan.per_tx)
    ops += plan.rows * plan.cols * (n_tx - 1) * (3 if with_grad else 1)
    ops += OPS_PER_WALL * W + OPS_PER_IMAGE * sum(int(c.numel()) for _, c in inputs.cands) * n_tx
    return int(ops), int(tests), kept


def needed_ops(ops: int, tests: int, census: dict) -> float:
    """Operations a looped map needs once the redesign's proofs are
    counted: ``ops_left``'s count with its ``tests`` blocked tests (each
    at ``OPS_TEST``) replaced by the share of them whose candidate's
    on-object and loss gates are live (the others need no blocked test),
    each at ``OPS_REJECT`` where the rejection proves the miss and at
    ``OPS_TEST`` elsewhere; the shares are
    ``looped_tuning.sweep_census``'s, on a uniform sample of this map's
    tiles."""
    listed = max(census["listed"], 1)
    live, live_rej = census["live"], census["live_rejected"]
    per_test = (OPS_REJECT * live_rej + OPS_TEST * (live - live_rej)) / listed
    return ops - OPS_TEST * tests + per_test * tests


def census_of(a_t, city, X, Y, grad: bool) -> dict:
    """``looped_tuning.sweep_census`` of a looped request's plan on 32
    tiles spread evenly over the grid."""
    from differt2d_tpu_torch.ops.looped_tuning import sweep_census

    plan, inputs = a_t[7], a_t[6]
    T = plan.tiles[0] * plan.tiles[1]
    tiles = list(range(0, T, max(1, T // 32)))
    return sweep_census(city, X, Y, plan, inputs, a_t[5], tiles, grad)


def twin_times(new, twin, k: int, reps: int) -> tuple:
    """``(new ms, twin ms, all four)``: the redesigned kernel and its
    sequential twin timed in turns (twin, new, new, twin), each the median
    of ``reps`` runs of ``k`` chained maps; each side the mean of its two
    turns."""
    t = [cuda_time_ms(f, k, reps) for f in (twin, new, new, twin)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


# Operations of the culling-table build (B7, ops/cull_tables.py), counted
# from its shapes as OPS_* above (compares, min/max, abs and the integer bit
# packing free): per sub-box, tile, candidate and bounce, the interval
# bounds of the bounce's wall parameter in beam_keep_tables (two affine
# intervals 16, the denominator margin 2, four interval quotients 4, the
# pad 4); per tile and wall, the grown hull of last_masks' _hull_mask
# (diagonal 6, growth 2, grown corners 4); with middle segments, per wall
# triple the lane of pair_occlusion_dead (side tests 4, four crossing
# ratios 8, four projections 28, the pad 3, about 45) and per wall pair the
# hull of mid_masks (12).  The per-wall work (first walls, shadow geometry)
# is a few hundred thousand operations and is left out.
OPS_BEAM = 26
OPS_HULL = 12
OPS_PAIR_LANE = 45


def table_ops(plan, inputs, num_walls: int) -> int:
    """Operations of the table build of ``plan``, summed over its
    transmitters."""
    from differt2d_tpu_torch.ops.power_map_looped import refine_for

    refine = refine_for(inputs.num_candidates)
    tiles = plan.per_tx[0].tables.losw.shape[0]
    bounces = sum(int(c.numel()) for _, c in inputs.cands)
    per_tx = refine * refine * tiles * bounces * OPS_BEAM + tiles * num_walls * OPS_HULL
    if inputs.max_order >= 2:
        per_tx += num_walls ** 3 * OPS_PAIR_LANE + num_walls ** 2 * OPS_HULL
    return per_tx * len(plan.per_tx)


def main() -> int:
    import torch

    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    try:
        card, smi_error = smi("name,power.limit"), None
    except (OSError, subprocess.SubprocessError) as exc:
        card, smi_error = None, exc
    if card is not None:
        print(card, flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(card is not None, f"nvidia-smi could not read the card ({smi_error})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind} x{count}", flush=True)

    import_port()
    from differt2d_tpu_torch import Scene, power_map
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import _build
    from differt2d_tpu_torch.ops import power_map_kernel as pmk
    from differt2d_tpu_torch.ops import opt_solver_kernel as osk
    from differt2d_tpu_torch.ops import power_map_looped as pml
    from differt2d_tpu_torch.rt import path_candidate_matrices

    # -- 2. build: one nvcc per source, all started together --------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    pmk.load_library()
    pml.load_library()
    osk.load_library()
    for src, (lib_path, nvcc_s) in built.items():
        print(f"build {src}: {nvcc_s:.1f} s in nvcc -> {lib_path}", flush=True)
        for line in _build.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s total", flush=True)

    # -- 3. main path at full size ------------------------------------------------
    n = 1024
    scene = Scene.basic_scene()
    X, Y = grid(n, dev)
    main_kw = dict(max_order=1, approx=True)
    pmk.reset_launches()
    Z = power_map(scene, X, Y, **main_kw)
    Zv, dZ = power_map(scene, X, Y, value_and_grad=True, **main_kw)
    torch.cuda.synchronize()
    launches = dict(pmk.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    check(launches["power_map_value"] >= 1, "power_map_value was not launched on the main path")
    check(launches["power_map_vag"] >= 1, "power_map_vag was not launched on the main path")
    check(Z.shape == (n, n) and dZ.shape == (n, n, 2), "main path: wrong output shapes")

    groups = path_candidate_matrices(scene.num_objects, 0, 1)
    inputs = pmk.kernel_inputs(groups, dev, approx=True, sigmoid=False)
    px, py = X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = (100.0, 1e-2, 0.0, 0.5, 0.1)
    args = (px, py, txs, scene.walls, scene.kind, scene.phi, scal, inputs)
    ref_v = pmk.plain_value(*args)
    ref_vv, ref_g = pmk.plain_value_and_grad(*args)
    err_value = assert_close("value map 1024^2", Z.reshape(-1), ref_v)
    assert_close("vag value 1024^2", Zv.reshape(-1), ref_vv)
    err_vag = max(max_abs(Zv.reshape(-1), ref_vv), assert_kinks("vag gradient 1024^2", dZ.reshape(-1, 2), ref_g))
    check(float(Z.sum()) > 0.0, "main path: the map is all zero")
    print(f"main path ok: value err {err_value:.3g}, vag err {err_vag:.3g}", flush=True)

    # -- 4. coverage at 256^2 -----------------------------------------------------------
    m = 256
    Xs, Ys = grid(m, dev)
    mixed = Scene.square_scene().add_ris([[0.5, 0.3], [0.5, 0.7]]).add_vertex([0.25, 0.75])
    two_tx = scene.update_transmitters(tx2=[0.8, 0.8])
    cases = [
        ("hard logic", scene, dict(max_order=1, approx=False)),
        ("sigmoid", scene, dict(max_order=1, approx=True, function=sigmoid)),
        ("RIS + vertex", mixed, dict(max_order=1, approx=True)),
        ("two TX", two_tx, dict(max_order=1, approx=True)),
        ("TX grid", scene, dict(max_order=1, approx=True, on_transmitters=True)),
        ("order 2", scene, dict(max_order=2, approx=True)),
    ]
    for name, sc, kw in cases:
        before = dict(pmk.LAUNCHES)
        got = power_map(sc, Xs, Ys, **kw)
        check(pmk.LAUNCHES["power_map_value"] > before["power_map_value"],
              f"{name}: the value kernel did not run")
        # The plain version on the kernel's own inputs: a transmitter grid
        # runs as the receiver grid of the swapped scene (path reversal).
        rsc, rkw = sc, kw
        if kw.get("on_transmitters"):
            rsc, rkw = sc.swap_ends(), {**kw, "on_transmitters": False}
        ref = power_map(rsc, Xs, Ys, backend="torch", **rkw)
        assert_close(f"{name} value", got, ref)
        if kw["max_order"] <= 1:
            gv, gg = power_map(sc, Xs, Ys, value_and_grad=True, **kw)
            rv, rg = power_map(rsc, Xs, Ys, value_and_grad=True, backend="torch", **rkw)
            assert_close(f"{name} vag value", gv, rv)
            assert_kinks(f"{name} vag gradient", gg, rg)

    # -- 5. autograd through the kernel ---------------------------------------------
    def scene_grads(backend):
        walls = scene.walls.detach().clone().requires_grad_(True)
        tx = scene.transmitters["tx"].detach().clone().requires_grad_(True)
        alpha = torch.tensor(100.0, device=dev, requires_grad=True)
        sc = Scene.from_arrays(walls, scene.kind, scene.phi, {"tx": tx}, scene.receivers)
        out = power_map(sc, Xs, Ys, max_order=1, approx=True, alpha=alpha, backend=backend)
        return (out, *torch.autograd.grad(out.sum(), (walls, tx, alpha)))

    before = pmk.LAUNCHES["power_map_value"]
    got = scene_grads("auto")
    check(pmk.LAUNCHES["power_map_value"] > before, "autograd: the value kernel did not run")
    ref = scene_grads("torch")
    for name, a, b in zip(("value", "d/dwalls", "d/dtx", "d/dalpha"), got, ref):
        assert_close(f"autograd {name}", a, b)
    print("autograd through the kernel ok", flush=True)

    # -- 6. timing -----------------------------------------------------------------------------
    P = n * n
    k, reps = 32, 5
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(smi("clocks.max.sm").split()[0])
    peak_fp32 = props.multi_processor_count * 128 * 2 * max_mhz * 1e6
    print(f"peak fp32 {peak_fp32 / 1e12:.1f} TFLOP/s ({props.multi_processor_count} SMs x 128"
          f" x 2 x {max_mhz:.0f} MHz)", flush=True)

    def kernel_call(with_grad):
        fn = pmk.value_and_grad if with_grad else pmk.value
        return lambda: fn(*args, approx=True, sigmoid=False)

    e2e_ms = cuda_time_ms(lambda: power_map(scene, X, Y, **main_kw), k, reps)
    e2e_vag_ms = cuda_time_ms(lambda: power_map(scene, X, Y, value_and_grad=True, **main_kw), k, reps)
    bands = pmk.sigmoid_bands(dev)
    print("sigmoid bands of power_map.cu on the card (every float32 past -18, -89 and 19): "
          + ("hold: sigmoid value and gradient maps run with the rejection and the saturation"
             " exit" if bands else "FAIL: sigmoid value and gradient maps run without the"
             " rejection and the saturation exit"), flush=True)
    rows = []
    for name, with_grad, err in (("power_map_value", False, err_value),
                                 ("power_map_vag", True, err_vag)):
        before = pmk.LAUNCHES[name]
        twin = pmk.twin_value_and_grad if with_grad else pmk.twin_value
        # The redesign against its sequential twin, in turns.
        ms, twin_ms, turns = twin_times(
            kernel_call(with_grad), lambda: twin(*args, approx=True, sigmoid=False), k, reps)
        per_map = (pmk.LAUNCHES[name] - before) / (2 * (k * reps + 1))
        plain = pmk.plain_value_and_grad if with_grad else pmk.plain_value
        plain_ms = cuda_time_ms(lambda: plain(*args), 2, 3)
        census = unrolled_census(scene, X, Y, groups, txs, scal, dev, with_grad)
        bytes_moved = P * (8 + (12 if with_grad else 4))
        ops_px, ops_launch = ops_count(groups, scene.kinds, txs.shape[0], with_grad)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        # The work these inputs need: the tests of gate-live candidates,
        # rejected ones at OPS_REJECT (needed_ops, from the census).
        tests = census["tests_px"] * P
        needed = needed_ops(P * ops_px + ops_launch, tests, census)
        t_ops = needed / peak_fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"{name}: {ms:.4f} ms/map, {P / ms * 1e3:.4g} points/s, {per_map:g} launches/map;"
              f" plain {plain_ms:.3f} ms/map; bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of the"
              f" kernel's time ({needed / P:.1f} ops/px needed of {ops_px} ops/px + {ops_launch}"
              f" per launch with every test, {bytes_moved / P:.0f} B/px)", flush=True)
        print(f"{name}: redesigned {ms:.4f} ms/map against its sequential twin {name}_seq"
              f" {twin_ms:.4f} ms/map (turns twin, new, new, twin:"
              f" {', '.join(f'{x:.4f}' for x in turns)}) [{card}]", flush=True)
        unrolled_issue_bound(scene, census, P, with_grad)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "twin_ms": twin_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        })
    print(f"end to end power_map 1024^2: value {e2e_ms:.4f} ms/map ({P / e2e_ms * 1e3:.4g}"
          f" points/s), value+grad {e2e_vag_ms:.4f} ms/map ({P / e2e_vag_ms * 1e3:.4g} points/s)",
          flush=True)
    print("library_ms: null -- no single PyTorch call computes this map", flush=True)
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s", flush=True)
    for first, phases in ((7, city_phases), (11, solver_phases), (15, order2_phases)):
        t0 = time.perf_counter()
        rows += phases(dev, peak_fp32)
        print(f"phases {first}-{first + 3}: {time.perf_counter() - t0:.1f} s", flush=True)
    twin_phase(dev)
    redesign_phase(dev)
    value_router_phase(dev)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def city_grid(n: int, device):
    import torch

    x = torch.linspace(0.01, 0.99, n, device=device)
    return torch.meshgrid(x, x, indexing="xy")


def looped_request(sc, X, Y, kw, dev, grad=False, **plan_kw):
    """The looped wrapper's inputs for ``power_map(sc, X, Y, **kw)``:
    ``(args, kernel kw, gates, replan)``, with the dispatch's gates unless
    ``plan_kw`` overrides them; ``replan()`` builds the plan (constants and
    tables) again.  Fails unless the request (a gradient map with ``grad``)
    routes to the looped kernels."""
    import torch

    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import power_map_looped as pml

    o = {**tr._OPTIONS, **kw}
    groups = tr._groups_for(sc, o)
    check(tr._route(sc, o, groups, "auto", grad=grad) == "looped",
          "the request does not route to the looped kernels")
    cull, shadow = tr._looped_gates(sc, o, groups)
    sig = o["function"] is sigmoid
    target = sc.swap_ends() if o["on_transmitters"] else sc
    txs = torch.stack(list(target.transmitters.values())).contiguous()
    inputs = pml.looped_inputs(groups, dev, approx=o["approx"], sigmoid=sig)
    scal = tuple(o[name] for name in tr._SCALAR_NAMES)

    def replan():
        return pml.make_plan(X, Y, txs, sc.walls, sc.kind, scal, inputs,
                             approx=o["approx"], sigmoid=sig,
                             **{"cull": cull, "shadow": shadow, **plan_kw})

    args = (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), sc.walls, sc.kind,
            sc.phi, scal, inputs, replan())
    return args, dict(approx=o["approx"], sigmoid=sig), (cull, shadow), replan


def assert_bitwise(name, a, b) -> None:
    import torch

    check(torch.equal(a, b), f"{name}: culled and identity-table maps differ at"
                             f" {int((a != b).sum())} elements")
    print(f"  {name}: culled == identity tables, bit for bit ({a.numel()} elements)",
          flush=True)


def city_phases(dev, peak_fp32: float) -> list:
    """Phases 7-10: the city path (``Scene.city_extract_scene()``, order
    <= 1, looped kernels with tile culling and occluder lists)."""
    import torch

    from differt2d_tpu_torch import Scene, eager, power_map
    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import power_map_kernel as pmk
    from differt2d_tpu_torch.ops import power_map_looped as pml

    # -- 7. the city path at full size ------------------------------------------------------
    n = 1024
    city = Scene.city_extract_scene()
    X, Y = city_grid(n, dev)
    kw = dict(max_order=1, approx=True)
    traced = []
    trace_group = eager._trace_group
    eager._trace_group = lambda *a, **k: traced.append(1) or trace_group(*a, **k)
    pml.reset_launches()
    unrolled_before = dict(pmk.LAUNCHES)
    Z = power_map(city, X, Y, **kw)
    Zv, dZ = power_map(city, X, Y, value_and_grad=True, **kw)
    torch.cuda.synchronize()
    launches = dict(pml.LAUNCHES)
    eager._trace_group = trace_group
    print(f"city path launches: {launches}", flush=True)
    check(launches["power_map_looped_value"] >= 1, "power_map_looped_value did not run")
    check(launches["power_map_looped_vag"] >= 1, "power_map_looped_vag did not run")
    check(dict(pmk.LAUNCHES) == unrolled_before, "the city path ran an unrolled kernel")
    check(not traced, "the city path ran the eager tracer")
    check(Z.shape == X.shape and dZ.shape == (*X.shape, 2), "city path: wrong output shapes")
    check(bool(torch.isfinite(Z).all() and torch.isfinite(dZ).all()), "city path: non-finite")
    check(float(Z.sum()) > 0.0, "city path: the map is all zero")
    args, kkw, gates, _ = looped_request(city, X, Y, kw, dev)
    ident, _, _, _ = looped_request(city, X, Y, kw, dev, cull=False, shadow=False)
    print(f"city path gates (cull, shadow): {gates}", flush=True)
    cv = pml.value(*args, **kkw)
    iv = pml.value(*ident, **kkw)
    cvv, cg = pml.value_and_grad(*args, **kkw)
    ivv, ig = pml.value_and_grad(*ident, **kkw)
    assert_bitwise("value map 1024^2", cv, iv)
    assert_bitwise("vag value 1024^2", cvv, ivv)
    assert_bitwise("vag gradient 1024^2", cg, ig)
    check(torch.equal(Z.reshape(-1), cv) and torch.equal(dZ.reshape(-1, 2), cg),
          "power_map's output differs from the wrapper's on the same tables")

    # Each kernel against its plain version on the main path's 1024^2 inputs
    # (these errors and plain times go into the kernels line), then on a
    # 256^2 map (cfg6/cfg7's size).  Each plain call is timed once.
    m = 256
    Xs, Ys = city_grid(m, dev)
    a256, _, _, _ = looped_request(city, Xs, Ys, kw, dev)
    err, plain_ms = {}, {}
    for size, a_t, (Xg, Yg) in ((n, args, (X, Y)), (m, a256, (Xs, Ys))):
        ref, plain_ms[size, False] = timed(lambda: pml.plain_looped_value(*a_t))
        err[size, False] = assert_close(f"city value {size}^2", pml.value(*a_t, **kkw), ref)
        (rv, rg), plain_ms[size, True] = timed(lambda: pml.plain_looped_value_and_grad(*a_t))
        gv, gg = pml.value_and_grad(*a_t, **kkw)
        err[size, True] = max(assert_close(f"city vag value {size}^2", gv, rv),
                              assert_kinks(f"city vag gradient {size}^2", gg, rg))
        print(f"city path ok at {size}^2: value err {err[size, False]:.3g}, vag err"
              f" {err[size, True]:.3g}; plain {plain_ms[size, False]:.1f} / {plain_ms[size, True]:.1f}"
              f" ms/map", flush=True)
        kink_probe(f"city vag gradient {size}^2", city, Xg, Yg, kw, gg, rg)

    # -- 8. coverage at 256^2 ----------------------------------------------------------------
    mixed = city.add_ris([[0.58, 0.35], [0.62, 0.35]]).add_vertex([0.45, 0.62])
    print(f"sigmoid saturation check on the card: {pml.sigmoid_saturates(dev)}", flush=True)
    cases = [
        ("city_scene", Scene.city_scene(), kw),
        ("hard logic", city, dict(max_order=1, approx=False)),
        ("sigmoid alpha=3000", city, dict(max_order=1, approx=True, function=sigmoid,
                                          alpha=3000.0)),
        ("sigmoid alpha=100", city, dict(max_order=1, approx=True, function=sigmoid)),
        ("two TX", city.update_transmitters(tx2=[0.5, 0.45]), kw),
        ("TX grid", city, dict(kw, on_transmitters=True)),
        ("RIS + vertex", mixed, kw),
    ]
    for name, sc, ckw in cases:
        before = dict(pml.LAUNCHES)
        got = power_map(sc, Xs, Ys, **ckw)
        gv, gg = power_map(sc, Xs, Ys, value_and_grad=True, **ckw)
        check(pml.LAUNCHES["power_map_looped_value"] > before["power_map_looped_value"]
              and pml.LAUNCHES["power_map_looped_vag"] > before["power_map_looped_vag"],
              f"{name}: the looped kernels did not run")
        a, kk, gates, _ = looped_request(sc, Xs, Ys, ckw, dev)
        ia, _, _, _ = looped_request(sc, Xs, Ys, ckw, dev, cull=False, shadow=False)
        print(f"  {name}: gates (cull, shadow) {gates}", flush=True)
        assert_close(f"{name} value", got.reshape(-1), pml.plain_looped_value(*a))
        rv, rg = pml.plain_looped_value_and_grad(*a)
        assert_close(f"{name} vag value", gv.reshape(-1), rv)
        assert_kinks(f"{name} vag gradient", gg.reshape(-1, 2), rg)
        assert_bitwise(f"{name} value", got.reshape(-1), pml.value(*ia, **kk))
        iv, ig = pml.value_and_grad(*ia, **kk)
        assert_bitwise(f"{name} vag", torch.cat([gv.reshape(-1), gg.reshape(-1)]),
              torch.cat([iv, ig.reshape(-1)]))

    # -- 9. autograd through the looped value kernel ------------------------------------------
    Xa, Ya = city_grid(64, dev)

    def scene_grads(backend):
        walls = city.walls.detach().clone().requires_grad_(True)
        tx = city.transmitters["tx"].detach().clone().requires_grad_(True)
        alpha = torch.tensor(100.0, device=dev, requires_grad=True)
        sc = Scene.from_arrays(walls, city.kind, city.phi, {"tx": tx}, city.receivers)
        out = power_map(sc, Xa, Ya, max_order=1, approx=True, alpha=alpha, backend=backend)
        return (out, *torch.autograd.grad(out.sum(), (walls, tx, alpha)))

    before = pml.LAUNCHES["power_map_looped_value"]
    got = scene_grads("auto")
    check(pml.LAUNCHES["power_map_looped_value"] > before, "autograd: the looped kernel did not run")
    ref = scene_grads("torch")
    for name, a, b in zip(("value", "d/dwalls", "d/dtx", "d/dalpha"), got, ref):
        assert_close(f"city autograd {name}", a, b)
    print("autograd through the looped kernel ok", flush=True)

    # -- 10. timing ----------------------------------------------------------------------------
    rows = []
    k, reps = 8, 5
    for size, (Xt, Yt), a_t, i_t in ((n, (X, Y), args, ident), (m, (Xs, Ys), a256, None)):
        P = Xt.numel()
        if i_t is None:
            i_t, _, _, _ = looped_request(city, Xt, Yt, kw, dev, cull=False, shadow=False)
        plan = a_t[-1]
        tables_mb = sum(tp.tables.nbytes for tp in plan.per_tx) / 1e6
        replan = looped_request(city, Xt, Yt, kw, dev)[3]
        build_ms = cuda_time_ms(replan, k, reps)
        e2e = {g: cuda_time_ms(lambda g=g: power_map(city, Xt, Yt, value_and_grad=g, **kw), k, reps)
               for g in (False, True)}
        t_bytes = tables_mb * 1e6 / HBM_BYTES_PER_S * 1e3
        t_ops = table_ops(plan, a_t[6], len(city.kinds)) / peak_fp32 * 1e3
        print(f"city {size}^2: table build (B7) bound {max(t_bytes, t_ops):.4f} ms (by"
              f" {'operations' if t_ops >= t_bytes else 'bytes'}: {t_bytes:.4f} ms to write the"
              f" tables, {t_ops:.4f} ms of operations), {max(t_bytes, t_ops) / build_ms:.2%} of"
              f" the build", flush=True)
        print(f"city {size}^2: table build {build_ms:.4f} ms/map ({tables_mb:.2f} MB of tables);"
              f" end to end power_map value {e2e[False]:.4f} ms/map ({P / e2e[False] * 1e3:.4g}"
              f" points/s), value+grad {e2e[True]:.4f} ms/map ({P / e2e[True] * 1e3:.4g}"
              f" points/s)", flush=True)
        for name, with_grad in (("power_map_looped_value", False),
                                ("power_map_looped_vag", True)):
            fn = pml.value_and_grad if with_grad else pml.value
            twin = pml.twin_value_and_grad if with_grad else pml.twin_value
            before = pml.LAUNCHES[name]
            ms, twin_ms, turns = twin_times(lambda: fn(*a_t, **kkw), lambda: twin(*a_t, **kkw),
                                            k, reps)
            per_map = (pml.LAUNCHES[name] - before) / (2 * (k * reps + 1))
            ident_ms = cuda_time_ms(lambda: fn(*i_t, **kkw), k, reps)
            ops_all, tests_all, kept_all = ops_left(i_t[-1], a_t[6], city.kinds, with_grad)
            ops_listed, tests, kept = ops_left(plan, a_t[6], city.kinds, with_grad)
            census = census_of(a_t, city, Xt, Yt, with_grad)
            ops = needed_ops(ops_listed, tests, census)
            kept, kept_all = kept[1], kept_all[1]
            per_px, per_launch = ops_count(a_t[6].groups, city.kinds, 1, with_grad)
            check(ops_all == P * per_px + per_launch,
                  f"identity-table count {ops_all} != ops_count {P * per_px + per_launch}")
            out_b = P * (8 + (12 if with_grad else 4))
            t_bytes = (out_b + tables_mb * 1e6) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / peak_fp32 * 1e3
            t_ops_all = ops_all / peak_fp32 * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_all = max(out_b / HBM_BYTES_PER_S * 1e3, t_ops_all)
            listed_ms = max(t_bytes, ops_listed / peak_fp32 * 1e3)
            line = (f"{name} {size}^2: culled {ms:.4f} ms/map ({P / ms * 1e3:.4g} points/s,"
                    f" {per_map:g} launches/map); sequential twin {twin_ms:.4f} ms/map"
                    f" (turns twin, new, new, twin: {', '.join(f'{x:.4f}' for x in turns)});"
                    f" identity tables (B3) {ident_ms:.4f} ms/map;"
                    f" bound (work these inputs need) {bound_ms:.4f} ms = {bound_ms / ms:.1%} of"
                    f" culled (gates live for {census['live'] / max(census['listed'], 1):.2%} of"
                    f" the listed tests, {census['rejected'] / max(census['listed'], 1):.2%}"
                    f" rejected; {ops / P:.0f} ops/px); bound (every listed test at full cost)"
                    f" {listed_ms:.4f} ms = {listed_ms / ms:.1%} of culled;"
                    f" bound (unculled) {bound_all:.4f} ms = {bound_all / ident_ms:.1%} of B3,"
                    f" {bound_all / ms:.1%} of culled; kept {kept / kept_all:.1%} of"
                    f" candidate-pixels, {tests / tests_all:.1%} of blocked tests"
                    f" ({ops_listed / P:.0f} vs {ops_all / P:.0f} ops/px);"
                    f" plain {plain_ms[size, with_grad]:.1f} ms/map (one call)")
            print(line, flush=True)
            if size == n:
                rows.append({
                    "name": name, "route": "cuda", "source": LOOPED_SOURCE,
                    "replaces": LOOPED_REPLACES, "launches": launches[name],
                    "max_abs_err": err[size, with_grad], "ms": ms, "twin_ms": twin_ms,
                    "plain_ms": plain_ms[size, with_grad], "bound_ms": bound_ms,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": None,
                })
    return rows


def random_city(seed: int, n_buildings: int, device):
    """``Scene`` of rotated rectangular buildings (4 walls each) and a
    transmitter, from a NumPy seed."""
    import numpy as np

    from differt2d_tpu_torch import Scene

    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(n_buildings):
        cx, cy = rng.uniform(0.05, 0.95, 2)
        w, h = rng.uniform(0.005, 0.03, 2)
        c, s = np.cos(rng.uniform(0, np.pi)), np.sin(rng.uniform(0, np.pi))
        pts = [(cx + c * dx - s * dy, cy + s * dx + c * dy)
               for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h))]
        walls += [[pts[i - 1], pts[i]] for i in range(4)]
    tx = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    return Scene.from_arrays(np.asarray(walls, np.float32), transmitters={"tx": tx},
                             receivers={"rx": [0.5, 0.5]}, device=device)


def tile_block(X, plan, t: int):
    """The pixels of tile ``t`` of ``plan`` in the ``[rows, cols]`` grid ``X``."""
    tw, th = plan.tile
    r, c = divmod(t, plan.tiles[0])
    return X[r * th:(r + 1) * th, c * tw:(c + 1) * tw]


ORDER2_SIZES = (1024, 256, 32)
"""Grids of the order-2 phases: the main path, cfg8's own size, coverage."""


def order2_phases(dev, peak_fp32: float) -> list:
    """Phases 15-18: the order-2 city path (``Scene.city_extract_scene()``,
    ``max_order=2``, looped kernels with middle-segment words and pair
    kills)."""
    import torch

    from differt2d_tpu_torch import Scene, eager, power_map
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import opt_solver_kernel as osk
    from differt2d_tpu_torch.ops import power_map_kernel as pmk
    from differt2d_tpu_torch.ops import power_map_looped as pml
    from differt2d_tpu_torch.ops.cull_tables import unpack_words

    # -- 15. the order-2 path at full size ------------------------------------------------
    t_phase = time.perf_counter()
    n, m, q = ORDER2_SIZES
    city = Scene.city_extract_scene()
    X, Y = city_grid(n, dev)
    kw = dict(max_order=2, approx=True)
    traced = []
    trace_group = eager._trace_group
    eager._trace_group = lambda *a, **k: traced.append(1) or trace_group(*a, **k)
    pml.reset_launches()
    others = (dict(pmk.LAUNCHES), dict(osk.LAUNCHES))
    Z = power_map(city, X, Y, **kw)
    Zv, dZ = power_map(city, X, Y, value_and_grad=True, **kw)
    torch.cuda.synchronize()
    launches = dict(pml.LAUNCHES)
    eager._trace_group = trace_group
    print(f"order-2 path launches: {launches}", flush=True)
    check(launches["power_map_looped_value"] >= 1, "order 2: power_map_looped_value did not run")
    check(launches["power_map_looped_vag"] >= 1, "order 2: power_map_looped_vag did not run")
    check((dict(pmk.LAUNCHES), dict(osk.LAUNCHES)) == others,
          "the order-2 path ran an unrolled or solver kernel")
    check(not traced, "the order-2 path ran the eager tracer")
    check(Z.shape == X.shape and dZ.shape == (*X.shape, 2), "order 2: wrong output shapes")
    check(bool(torch.isfinite(Z).all() and torch.isfinite(dZ).all()), "order 2: non-finite")
    args, kkw, gates, replan = looped_request(city, X, Y, kw, dev)
    inputs, plan = args[6], args[7]
    W = city.num_objects
    check(inputs.orders == (1, 2) and inputs.num_candidates == W * W,
          f"order 2: candidate groups {inputs.orders}, {inputs.num_candidates}")
    print(f"order-2 path gates (cull, shadow): {gates}", flush=True)
    cv = pml.value(*args, **kkw)
    cvv, cg = pml.value_and_grad(*args, **kkw)
    check(torch.equal(Z.reshape(-1), cv) and torch.equal(Zv.reshape(-1), cvv)
          and torch.equal(dZ.reshape(-1, 2), cg),
          "order 2: power_map's output differs from the wrapper's on the same tables")
    # Z includes the order-2 group: more than the order-1 map.
    z1 = power_map(city, X, Y, max_order=1, approx=True)
    check(float((Z - z1).sum()) > 0.0, "order 2: the order-2 group adds nothing")
    del z1
    ident = looped_request(city, X, Y, kw, dev, cull=False, shadow=False)[0]
    iv, ident_ms_1024 = timed(lambda: pml.value(*ident, **kkw))
    assert_bitwise(f"order-2 value map {n}^2", cv, iv)
    print(f"  identity tables (unculled), one value call {n}^2: {ident_ms_1024:.1f} ms",
          flush=True)
    del ident, iv
    Xs, Ys = city_grid(m, dev)
    a256 = looped_request(city, Xs, Ys, kw, dev)[0]
    i256 = looped_request(city, Xs, Ys, kw, dev, cull=False, shadow=False)[0]
    assert_bitwise(f"order-2 value map {m}^2", pml.value(*a256, **kkw), pml.value(*i256, **kkw))
    gv, gg = pml.value_and_grad(*a256, **kkw)
    iv, ig = pml.value_and_grad(*i256, **kkw)
    assert_bitwise(f"order-2 vag {m}^2", torch.cat([gv, gg.reshape(-1)]),
                   torch.cat([iv, ig.reshape(-1)]))
    ident256 = i256
    # Four 16x16 tiles of the main map, side by side in one 16 x 64 grid:
    # the two with the most kept order-2 candidates, the transmitter's, a
    # corner.  Tile bounds, and so tables, are each tile's own.
    cnt2 = plan.per_tx[0].tables.cnt[-1]
    tx_xy = city.transmitters["tx"]
    x0, x1, y0, y1 = pml.tile_bounds(X, Y)
    cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    tx_tile = int(((cx - tx_xy[0]) ** 2 + (cy - tx_xy[1]) ** 2).argmin())
    most = [t for t in torch.argsort(cnt2, descending=True).tolist()[:4] if t not in (tx_tile, 0)]
    tiles = [most[0], most[1], tx_tile, 0]
    Xc = torch.cat([tile_block(X, plan, t) for t in tiles], dim=1).contiguous()
    Yc = torch.cat([tile_block(Y, plan, t) for t in tiles], dim=1).contiguous()
    at, _, _, _ = looped_request(city, Xc, Yc, kw, dev)
    tb, tbt = plan.per_tx[0].tables, at[7].per_tx[0].tables
    for k in range(len(inputs.orders)):
        check(torch.equal(tbt.cnt[k], tb.cnt[k][tiles])
              and torch.equal(tbt.prm[k], tb.prm[k][tiles]),
              "order 2: the four tiles' own tables differ from the map's")
    print(f"  tiles {tiles} (transmitter's {tx_tile}): kept order-2 candidates"
          f" {tbt.cnt[-1].tolist()}", flush=True)
    kt = pml.value(*at, **kkw)
    ktv, ktg = pml.value_and_grad(*at, **kkw)
    blocks = lambda A: torch.cat([tile_block(A, plan, t) for t in tiles], dim=1)  # noqa: E731
    check(torch.equal(kt, blocks(cv.reshape(n, n)).reshape(-1))
          and torch.equal(ktg, torch.cat([tile_block(cg.reshape(n, n, 2), plan, t)
                                          for t in tiles], dim=1).reshape(-1, 2)),
          "order 2: the four tiles' maps differ from the same pixels of the full map")
    ref, plain_v_ms = timed(lambda: pml.plain_looped_value(*at))
    err_v = assert_close(f"order-2 value, four tiles of {n}^2", kt, ref)
    (rv, rg), plain_g_ms = timed(lambda: pml.plain_looped_value_and_grad(*at))
    err_g = max(assert_close(f"order-2 vag value, four tiles of {n}^2", ktv, rv),
                assert_kinks(f"order-2 vag gradient, four tiles of {n}^2", ktg, rg))
    print(f"order-2 path ok at {n}^2: value err {err_v:.3g}, vag err {err_g:.3g}; plain (1,024"
          f" pixels, one call each) {plain_v_ms:.1f} / {plain_g_ms:.1f} ms", flush=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 16. coverage on a small grid -------------------------------------------------------
    t_phase = time.perf_counter()
    Xq, Yq = city_grid(q, dev)
    basic = Scene.basic_scene()
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "data", "city_extract.geojson")) as f:
        features = json.load(f)["features"][:6]
    six = Scene.from_geojson(json.dumps({"type": "FeatureCollection", "features": features}))
    big = random_city(7, 75, dev)
    print(f"sigmoid saturation check on the card: {pml.sigmoid_saturates(dev)}", flush=True)
    cases = [  # (name, scene, options, whether the value map is looped)
        ("hard logic", city, dict(max_order=2, approx=False), True),
        ("sigmoid alpha=3000", city, dict(max_order=2, approx=True, function=sigmoid,
                                          alpha=3000.0), True),
        ("city_scene", Scene.city_scene(), kw, True),
        ("two TX", city.update_transmitters(tx2=[0.5, 0.45]), kw, True),
        # 300 walls: beyond the JAX kernel's chunk words (its list fallback).
        ("random city, 300 walls", big, kw, True),
        ("basic scene, order 2", basic, kw, False),
        ("basic scene, order 3", basic, dict(max_order=3, approx=True), True),
        ("6 buildings, order 3", six, dict(max_order=3, approx=True), True),
    ]
    for name, sc, ckw, value_looped in cases:
        t_case = time.perf_counter()
        before = dict(pml.LAUNCHES)
        gv, gg = power_map(sc, Xq, Yq, value_and_grad=True, **ckw)
        check(pml.LAUNCHES["power_map_looped_vag"] > before["power_map_looped_vag"],
              f"{name}: the looped vag kernel did not run")
        a, kk, gates, _ = looped_request(sc, Xq, Yq, ckw, dev, grad=True)
        ia = looped_request(sc, Xq, Yq, ckw, dev, grad=True, cull=False, shadow=False)[0]
        iv, ig = pml.value_and_grad(*ia, **kk)
        assert_bitwise(f"{name} vag", torch.cat([gv.reshape(-1), gg.reshape(-1)]),
                       torch.cat([iv, ig.reshape(-1)]))
        if value_looped:
            got = power_map(sc, Xq, Yq, **ckw)
            check(pml.LAUNCHES["power_map_looped_value"] > before["power_map_looped_value"],
                  f"{name}: the looped value kernel did not run")
            assert_bitwise(f"{name} value", got.reshape(-1), pml.value(*ia, **kk))
        # Against the plain version on the side x side block of the grid
        # with the most nonzero pixels, side 16 (a tile) or less where the
        # plain version's work per pixel (blocked tests of every candidate)
        # is large; the block's tables are its own.
        work = sc.num_objects * sum(int(c.shape[0]) * (o + 1) for o, c in a[6].cands)
        side = 16 if work < 10**6 else (8 if work < 2 * 10**7 else 2)
        nb = q // side
        lit = (gv != 0).reshape(nb, side, nb, side).sum(dim=(1, 3)).reshape(-1)
        r0, c0 = (side * v for v in divmod(int(lit.argmax()), nb))
        Xb = Xq[r0:r0 + side, c0:c0 + side].contiguous()
        Yb = Yq[r0:r0 + side, c0:c0 + side].contiguous()
        ab = looped_request(sc, Xb, Yb, ckw, dev, grad=True)[0]
        kv, (kvv, kg) = pml.value(*ab, **kk), pml.value_and_grad(*ab, **kk)
        at_ = f"{side}^2 block at ({r0}, {c0})"
        assert_close(f"{name} value, {at_}", kv, pml.plain_looped_value(*ab))
        rv, rg = pml.plain_looped_value_and_grad(*ab)
        assert_close(f"{name} vag value, {at_}", kvv, rv)
        assert_kinks(f"{name} vag gradient, {at_}", kg, rg)
        check(float(kv.abs().sum()) > 0.0, f"{name}: the block's map is all zero")
        print(f"  {name}: gates (cull, shadow) {gates}, orders {a[6].orders},"
              f" {a[6].num_candidates} candidates, {sc.num_objects} walls;"
              f" {time.perf_counter() - t_case:.1f} s", flush=True)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 17. autograd through the looped value kernel -----------------------------------------
    t_phase = time.perf_counter()

    # On the 6 buildings (1,296 candidates): the backward is the plain
    # tracer's VJP over every candidate of every pixel.
    def scene_grads(backend):
        walls = six.walls.detach().clone().requires_grad_(True)
        tx = six.transmitters["tx"].detach().clone().requires_grad_(True)
        alpha = torch.tensor(100.0, device=dev, requires_grad=True)
        sc = Scene.from_arrays(walls, six.kind, six.phi, {"tx": tx}, six.receivers)
        out = power_map(sc, Xq, Yq, max_order=2, approx=True, alpha=alpha, backend=backend)
        return (out, *torch.autograd.grad(out.sum(), (walls, tx, alpha)))

    before = pml.LAUNCHES["power_map_looped_value"]
    got = scene_grads("auto")
    check(pml.LAUNCHES["power_map_looped_value"] > before,
          "order-2 autograd: the looped kernel did not run")
    ref = scene_grads("torch")
    for name, a_, b_ in zip(("value", "d/dwalls", "d/dtx", "d/dalpha"), got, ref):
        assert_close(f"order-2 autograd {name}", a_, b_)
    check(float(got[2].abs().sum()) > 0.0, "order-2 autograd: d/dtx is zero")
    print(f"autograd through the order-2 looped kernel ok; phase 17:"
          f" {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 18. timing ---------------------------------------------------------------------------
    t_phase = time.perf_counter()
    rows = []
    for size, (Xt, Yt), a_t, reps_k in ((n, (X, Y), args, 2), (m, (Xs, Ys), a256, 4)):
        P = Xt.numel()
        pl = a_t[7]
        tables_mb = sum(tp.tables.nbytes for tp in pl.per_tx) / 1e6
        prm2_mb = pl.per_tx[0].tables.prm[-1].numel() * 4 / 1e6
        rp = looped_request(city, Xt, Yt, kw, dev)[3]
        build_ms = cuda_time_ms(rp, reps_k, 5)
        e2e = {g: cuda_time_ms(lambda g=g: power_map(city, Xt, Yt, value_and_grad=g, **kw),
                               reps_k, 5) for g in (False, True)}
        t_bytes = tables_mb * 1e6 / HBM_BYTES_PER_S * 1e3
        t_ops = table_ops(pl, a_t[6], W) / peak_fp32 * 1e3
        print(f"order-2 city {size}^2: table build {build_ms:.4f} ms/map ({tables_mb:.2f} MB of"
              f" tables, prm_2 {prm2_mb:.2f} MB, refine {pml.refine_for(a_t[6].num_candidates)});"
              f" its bound {max(t_bytes, t_ops):.4f} ms (by"
              f" {'operations' if t_ops >= t_bytes else 'bytes'}), {max(t_bytes, t_ops) / build_ms:.2%}"
              f" of the build; end to end power_map value {e2e[False]:.4f} ms/map"
              f" ({P / e2e[False] * 1e3:.4g} points/s), value+grad {e2e[True]:.4f} ms/map"
              f" ({P / e2e[True] * 1e3:.4g} points/s)", flush=True)
        mid = unpack_words(pl.per_tx[0].tables.midw, W).float().mean()
        if size == m:
            ident_ms = cuda_time_ms(lambda: pml.value(*ident256, **kkw), 1, 3)
        for name, with_grad in (("power_map_looped_value", False),
                                ("power_map_looped_vag", True)):
            fn = pml.value_and_grad if with_grad else pml.value
            twin = pml.twin_value_and_grad if with_grad else pml.twin_value
            before = pml.LAUNCHES[name]
            ms, twin_ms, turns = twin_times(lambda: fn(*a_t, **kkw), lambda: twin(*a_t, **kkw),
                                            reps_k, 5)
            per_map = (pml.LAUNCHES[name] - before) / (2 * (reps_k * 5 + 1))
            ops_listed, tests, kept = ops_left(pl, a_t[6], city.kinds, with_grad)
            census = census_of(a_t, city, Xt, Yt, with_grad)
            ops = needed_ops(ops_listed, tests, census)
            per_px, per_launch = ops_count(a_t[6].groups, city.kinds, 1, with_grad)
            ops_all = P * per_px + per_launch
            tests_all = P * sum(cand_ops([int(i) for i in r], city.kinds, False)[1]
                                for g in a_t[6].groups.values() for r in g)
            if size == m:
                ops_i, _, _ = ops_left(ident256[7], a_t[6], city.kinds, with_grad)
                check(ops_i == ops_all, f"identity-table count {ops_i} != ops_count {ops_all}")
            out_b = P * (8 + (12 if with_grad else 4))
            t_bytes = (out_b + tables_mb * 1e6) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / peak_fp32 * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_all = max(out_b / HBM_BYTES_PER_S * 1e3, ops_all / peak_fp32 * 1e3)
            shares = ", ".join(f"order {o}: {kept[o] / (P * int(c.shape[0])):.2%}"
                               for o, c in a_t[6].cands)
            listed_ms = max(t_bytes, ops_listed / peak_fp32 * 1e3)
            line = (f"{name} order 2 {size}^2: culled {ms:.4f} ms/map ({P / ms * 1e3:.4g}"
                    f" points/s, {per_map:g} launches/map); sequential twin {twin_ms:.4f} ms/map"
                    f" (turns twin, new, new, twin: {', '.join(f'{x:.4f}' for x in turns)});"
                    f" bound (work these inputs need) {bound_ms:.4f} ms = {bound_ms / ms:.1%} of"
                    f" culled (gates live for {census['live'] / max(census['listed'], 1):.2%} of"
                    f" the listed tests, {census['rejected'] / max(census['listed'], 1):.2%}"
                    f" rejected; {ops / P:.0f} ops/px); bound (every listed test at full cost)"
                    f" {listed_ms:.4f} ms = {listed_ms / ms:.1%} of culled;"
                    f" bound (unculled) {bound_all:.4f} ms;"
                    f" kept candidate-pixels {shares}; blocked tests left {tests / tests_all:.3%}"
                    f" ({ops_listed / P:.0f} vs {ops_all / P:.0f} ops/px); middle-segment words"
                    f" list {float(mid):.1%} of the walls")
            if size == m and not with_grad:
                line += f"; identity tables (unculled) {ident_ms:.1f} ms/map"
            if size == n and not with_grad:
                line += f"; identity tables (unculled) {ident_ms_1024:.1f} ms (one call)"
            print(line, flush=True)
            if size == n:
                rows.append({
                    "name": name, "route": "cuda", "source": LOOPED_SOURCE,
                    "replaces": LOOPED_REPLACES, "path": "order-2 city (B5b)",
                    "launches": launches[name], "max_abs_err": err_g if with_grad else err_v,
                    "ms": ms, "twin_ms": twin_ms,
                    "plain_ms": plain_g_ms if with_grad else plain_v_ms,
                    "plain_pixels": int(at[0].numel()), "bound_ms": bound_ms,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": None,
                })
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def duplicated_wall_scene(device):
    """``Scene.basic_scene()`` with its third wall listed twice: two walls
    give the same blocked-test activation strictly inside (0, 1) wherever a
    segment passes near that wall, the redesigned sweep's tie case."""
    import numpy as np

    from differt2d_tpu_torch import Scene

    basic = Scene.basic_scene(device=device)
    w = basic.walls.cpu().numpy()
    return Scene.from_arrays(np.concatenate([w, w[2:3]]),
                             transmitters={"tx": basic.transmitters["tx"].cpu().numpy()},
                             receivers={"rx": [0.5, 0.5]}, device=device)


def twin_equal(a, b) -> bool:
    """``torch.equal``, with NaN equal to NaN at the same elements."""
    import torch

    if torch.equal(a, b):
        return True
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def twin_phase(dev) -> None:
    """Phase 19: the redesigned looped kernels against their sequential
    twins (``power_map_looped_value_seq`` / ``_vag_seq``, the same source
    with the redesign off), bit for bit on value and gradient: the 1024 x
    1024 order-2 and order-1 city maps, the 256 x 256 order-1 map, and at
    32 x 32 every phase-16 case, a RIS with a vertex and a duplicated wall
    (in-range ties)."""
    import torch

    from differt2d_tpu_torch import Scene
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import power_map_looped as pml

    t_phase = time.perf_counter()
    bands = pml.sigmoid_bands(dev)
    print(f"sigmoid bands on the card (every float32 past -18, -89 and 19): "
          + ("hold: sigmoid maps run with the rejection and the saturation exit" if bands else
             "FAIL: sigmoid maps run without the rejection and the saturation exit"),
          flush=True)
    n, m, q = ORDER2_SIZES
    city = Scene.city_extract_scene()
    with open(os.path.join(ROOT, "differt2d_tpu_torch", "data", "city_extract.geojson")) as f:
        features = json.load(f)["features"][:6]
    six = Scene.from_geojson(json.dumps({"type": "FeatureCollection", "features": features}))
    o2 = dict(max_order=2, approx=True)
    cases = [
        ("order-2 city", city, n, o2),
        ("order-1 city", city, n, dict(max_order=1, approx=True)),
        ("order-1 city", city, m, dict(max_order=1, approx=True)),
        ("hard logic", city, q, dict(max_order=2, approx=False)),
        ("sigmoid alpha=3000", city, q, dict(max_order=2, approx=True, function=sigmoid,
                                             alpha=3000.0)),
        ("sigmoid alpha=100", city, q, dict(max_order=2, approx=True, function=sigmoid)),
        ("city_scene", Scene.city_scene(), q, o2),
        ("two TX (accumulate)", city.update_transmitters(tx2=[0.5, 0.45]), q, o2),
        ("random city, 300 walls", random_city(7, 75, dev), q, o2),
        ("RIS + vertex", city.add_ris([[0.58, 0.35], [0.62, 0.35]]).add_vertex([0.45, 0.62]),
         q, o2),
        ("basic scene, order 2", Scene.basic_scene(), q, o2),
        ("basic scene, order 3", Scene.basic_scene(), q, dict(max_order=3, approx=True)),
        ("6 buildings, order 3", six, q, dict(max_order=3, approx=True)),
        ("duplicated wall, order 2", duplicated_wall_scene(dev), q, o2),
    ]
    for name, sc, size, kw in cases:
        X, Y = city_grid(size, dev)
        a, kk, _, _ = looped_request(sc, X, Y, kw, dev, grad=True)
        v, tv = pml.value(*a, **kk), pml.twin_value(*a, **kk)
        (gv, gg), (tgv, tgg) = pml.value_and_grad(*a, **kk), pml.twin_value_and_grad(*a, **kk)
        same = [twin_equal(v, tv), twin_equal(gv, tgv), twin_equal(gg, tgg)]
        check(all(same), f"{name} {size}^2: redesigned != sequential twin (value, vag value,"
                         f" gradient: {same}; {int((v != tv).sum())} /"
                         f" {int((gg != tgg).sum())} elements differ)")
        print(f"  {name} {size}^2: redesigned == sequential twin, torch.equal on value, vag value"
              f" and gradient ({v.numel()} pixels, {a[6].num_candidates} candidates)",
              flush=True)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- the redesigned B2 and B6: their parts, their SASS, and their twins (phases 6, 14, 20) --

_CENSUS: dict = {}


def kernel_census(source: str) -> dict:
    """``sass_census.kernel_loops`` of one built source, keyed by short
    kernel name (``opt_solver_kernel<1, 1, true>``), once per run."""
    from differt2d_tpu_torch.ops import _build, sass_census

    if source not in _CENSUS:
        path, _ = _build.build(source)
        loops = sass_census.kernel_loops(path)
        _CENSUS[source] = {sass_census.short_name(k): v for k, v in loops.items()}
    return _CENSUS[source]


def issue_slots_ms(instructions: float) -> float:
    """Least ms to issue ``instructions`` thread instructions: an SM issues
    four warp instructions (128 thread instructions) a clock, at the card's
    maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return instructions / (sms * 128 * mhz * 1e6) * 1e3


def describe(p: dict) -> str:
    keys = ("total", "fp32", "sfu", "MUFU.RCP", "MUFU.RSQ", "MUFU.EX2", "integer", "memory",
            "control", "slow_path_branches", "calls", "tests_a_pass")
    return ", ".join(f"{k} {p[k]:g}" for k in keys if p.get(k))


def adam_step(kernel: str, ris: bool) -> dict:
    """One adam step of solver ``kernel`` from its SASS: the pass of its
    adam loops (the innermost loops with two square roots or more a pass)
    through the RIS residual (``ris``: the fewest square roots, two a step)
    or through the wall residual or Fermat's lengths (the most, three a
    step), the shortest of those, divided by the steps the pass holds where
    the loop is unrolled; None where no pass holds a whole step."""
    loops = kernel_census("opt_solver.cu")[kernel]["loops"]
    cands = [p for loop in loops for p in loop if p.get("MUFU.RSQ", 0) >= 2]
    if not cands:
        return None  # no loop pass holds a whole step (a rotated or split loop)
    rsq = (min if ris else max)(q["MUFU.RSQ"] for q in cands)
    p = min((q for q in cands if q["MUFU.RSQ"] == rsq), key=lambda q: q["total"])
    steps = max(1, rsq // (2 if ris else 3))
    return {key: v / steps for key, v in p.items()}


def blocked_tests(kernel: str) -> tuple:
    """``(full test, rejected test)`` of a value or gradient ``kernel``'s
    blocked-test loops from its SASS (``sass_census.blocked_test``: the
    redesigned sweep's loops, with a bit scan, where it has them, else the
    sequential sweep's, with seg_margin's two divisions or seg_vag's three,
    per test)."""
    from differt2d_tpu_torch.ops import sass_census

    loops = kernel_census("power_map.cu")[kernel]["loops"]
    full, rej = sass_census.blocked_test(loops, sass_census.divisions_of(kernel))
    check(full is not None, f"{kernel}: no blocked-test loop in the SASS")
    return full, rej


def unrolled_census(scene, X, Y, groups, txs, scal, dev, grad: bool) -> dict:
    """``looped_tuning.sweep_census`` of an unrolled map (identity tables,
    32 tiles spread over the grid; ``grad`` picks the rejection bounds) with
    ``tests_px``, the blocked tests a pixel when every segment meets every
    non-adjacent, non-vertex wall."""
    from differt2d_tpu_torch.ops import power_map_looped as pml
    from differt2d_tpu_torch.ops.looped_tuning import sweep_census

    inputs = pml.looped_inputs(groups, dev, approx=True, sigmoid=False)
    plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs, approx=True,
                         sigmoid=False, cull=False, shadow=False)
    T = plan.tiles[0] * plan.tiles[1]
    c = sweep_census(scene, X, Y, plan, inputs, scal, list(range(0, T, max(1, T // 32))), grad)
    c["tests_px"] = sum(cand_ops([int(i) for i in row], scene.kinds, grad)[1]
                        for rows in groups.values() for row in rows) * txs.shape[0]
    return c


def unrolled_issue_bound(scene, c: dict, P: int, grad: bool) -> None:
    """Registers, blocks per SM, the instructions of one blocked test and
    the issue-slot bound of the 1024^2 basic-scene value (``grad`` False) or
    gradient map, for the redesigned kernel and its twin (hard_sigmoid, the
    main path's), from ``unrolled_census``'s ``c``: the twin runs every
    test in full, the redesign the gate-live ones, rejected or not."""
    from differt2d_tpu_torch.ops import power_map_kernel as pmk

    census = kernel_census("power_map.cu")
    listed = max(c["listed"], 1)
    base = "power_map_vag" if grad else "power_map_value"
    for name, fast in ((base, True), (f"{base}_seq", False)):
        kern = f"power_map_kernel<{'true' if grad else 'false'}, 1, {'true' if fast else 'false'}>"
        full, rej = blocked_tests(kern)
        if fast:
            per_test = ((c["live_rejected"] * rej["total"]
                         + (c["live"] - c["live_rejected"]) * full["total"]) / listed)
        else:
            per_test = full["total"]
        bound = issue_slots_ms(P * c["tests_px"] * per_test)
        print(f"{name} (hard_sigmoid): {census[kern]['registers']} registers,"
              f" {pmk.occupancy(grad, 1, fast, len(scene.kinds))} blocks of 128 per SM;"
              f" one blocked test: {describe(full)}"
              + (f"; a rejected test: {describe(rej)}" if rej else "")
              + f"; issue-slot bound {bound:.4f} ms ({c['tests_px']} tests/px"
              + (f", live {c['live'] / listed:.2%}, live and rejected"
                 f" {c['live_rejected'] / listed:.2%} of them" if fast else "")
              + ")", flush=True)


def solver_issue_bound(osk, inputs, num_walls: int, soft: int, ris: bool, P: int,
                       name: str) -> None:
    """Registers, blocks per SM, one adam step's instructions and the
    issue-slot bound of the solves of one map (every candidate's steps),
    for the redesigned kernel and its twin."""
    obj = osk.OBJECTIVES[inputs.objective]
    C = int(inputs.cand.numel())
    for kname, fast in (("opt_solver_value", True), ("opt_solver_value_seq", False)):
        kern = f"opt_solver_kernel<{soft}, {obj}, {'true' if fast else 'false'}>"
        step = adam_step(kern, ris)
        regs = kernel_census("opt_solver.cu")[kern]["registers"]
        blocks = osk.occupancy(inputs.objective, soft, fast, num_walls)
        steps = "one adam step: not measured (no loop pass holds a whole step)"
        if step is not None:
            bound = issue_slots_ms(P * C * inputs.steps * step["total"])
            steps = (f"one adam step: {describe(step)}; issue-slot bound of the steps"
                     f" {bound:.4f} ms")
        print(f"{kname}, {name}: {regs} registers, {blocks} blocks of"
              f" 128 per SM; {steps}", flush=True)


def redesign_phase(dev) -> None:
    """Phase 20: the redesigned opt_solver_value and power_map_vag against
    their sequential twins (the same sources with the redesign off),
    ``torch.equal`` (NaN equal to NaN at the same elements)."""
    import math

    import numpy as np
    import torch

    from differt2d_tpu_torch import Scene, prng
    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import opt_solver_kernel as osk
    from differt2d_tpu_torch.ops import power_map_kernel as pmk

    t_phase = time.perf_counter()
    key = prng.PRNGKey(1234)
    square = Scene.square_scene()
    ris = square.add_ris([[0.5, 0.3], [0.5, 0.7]], phi=math.pi / 4)
    ris_only = lambda o: o.kind == 1  # noqa: E731
    sq = square.walls.cpu().numpy()
    zero_wall = Scene.from_arrays(
        np.concatenate([sq, np.array([[[0.5, 0.5], [0.5, 0.5]]], np.float32)]),
        transmitters={"tx": square.transmitters["tx"].cpu().numpy()},
        receivers={"rx": [0.5, 0.5]}, device=dev)
    soft = dict(approx=True, key=key)
    fermat = dict(order=1, solver="fermat", steps=100, **soft)
    solver_cases = [  # (name, scene, size, options, candidate groups or None, grid)
        ("RIS MPT 1000 steps", ris, 1024,
         dict(order=1, solver="mpt", steps=1000, filter_objects=ris_only, **soft), None, None),
        ("walls Fermat", square, 1024, fermat, None, None),
        ("walls MPT", square, 1024, dict(order=1, solver="mpt", steps=100, **soft), None, None),
        ("walls Fermat orders 0-1", square, 256,
         dict(fermat, order=None, min_order=0, max_order=1), None, None),
        ("hard logic MPT", square, 256, dict(order=1, solver="mpt", steps=100, approx=False,
                                             key=key), None, None),
        ("sigmoid, orders 0-1", square, 256, dict(fermat, order=None, min_order=0,
                                                  max_order=1, function=sigmoid), None, None),
        ("two TX", square.update_transmitters(tx2=[0.8, 0.3]), 256, fermat, None, None),
        ("TX grid", square, 256, dict(fermat, on_transmitters=True), None, None),
        ("RIS + vertex", ris.add_vertex([0.25, 0.75]), 256,
         dict(order=1, solver="mpt", steps=300, **soft), {1: np.array([[4]], np.int32)}, None),
        ("zero-length wall on a pixel", zero_wall, 257,
         dict(order=1, solver="mpt", steps=100, **soft), None, (0.0, 1.0)),
    ]
    for name, sc, size, kw, groups, span in solver_cases:
        lo, hi = span or (0.01, 0.99)
        x = torch.linspace(lo, hi, size, device=dev)
        X, Y = torch.meshgrid(x, x, indexing="xy")
        o = {**tr._OPTIONS, **kw}
        if groups is None:
            groups = tr._groups_for(sc, o)
        args = osk.solver_request(sc, X, Y, groups, **tr._solver_options(o))
        kkw = dict(approx=o["approx"], sigmoid=o["function"] is sigmoid)
        before, twins = osk.LAUNCHES["opt_solver_value"], osk.TWIN_LAUNCHES["opt_solver_value_seq"]
        v, tv = osk.value(*args, **kkw), osk.twin_value(*args, **kkw)
        torch.cuda.synchronize()
        check(osk.LAUNCHES["opt_solver_value"] > before
              and osk.TWIN_LAUNCHES["opt_solver_value_seq"] > twins,
              f"{name}: the solver kernel or its twin did not run")
        check(twin_equal(v, tv), f"{name} {size}^2: opt_solver_value != opt_solver_value_seq at"
                                 f" {int((v != tv).sum())} pixels")
        print(f"  {name} {size}^2: opt_solver_value == opt_solver_value_seq, torch.equal"
              f" ({v.numel()} pixels, {int((v != 0).sum())} nonzero)", flush=True)

    basic = Scene.basic_scene()
    mixed = Scene.square_scene().add_ris([[0.5, 0.3], [0.5, 0.7]]).add_vertex([0.25, 0.75])
    o1 = dict(max_order=1, approx=True)
    vag_cases = [
        ("basic scene", basic, 1024, o1),
        ("hard logic", basic, 256, dict(max_order=1, approx=False)),
        ("sigmoid", basic, 256, dict(o1, function=sigmoid)),
        ("RIS + vertex", mixed, 256, o1),
        ("two TX", basic.update_transmitters(tx2=[0.8, 0.8]), 256, o1),
        ("TX grid", basic, 256, dict(o1, on_transmitters=True)),
        ("order 2", basic, 256, dict(max_order=2, approx=True)),
        ("duplicated wall, order 2", duplicated_wall_scene(dev), 256,
         dict(max_order=2, approx=True)),
        ("short walls", short_wall_scene(dev), 256, o1),
        ("short walls, sigmoid", short_wall_scene(dev), 256, dict(o1, function=sigmoid)),
    ]
    for name, sc, size, kw in vag_cases:
        args, kkw = unrolled_args(sc, *grid(size, dev), kw)
        (v, g), (tv, tg) = pmk.value_and_grad(*args, **kkw), pmk.twin_value_and_grad(*args, **kkw)
        same = [twin_equal(v, tv), twin_equal(g, tg)]
        check(all(same), f"{name} {size}^2: power_map_vag != power_map_vag_seq (value, gradient:"
                         f" {same}; {int((g != tg).sum())} gradient elements differ)")
        print(f"  {name} {size}^2: power_map_vag == power_map_vag_seq, torch.equal on value and"
              f" gradient ({v.numel()} pixels)", flush=True)

    # power_map_value against power_map_value_seq: the same cases, the
    # scene at the top of the value route and phase 11's line of sight.
    value_cases = [(name, *unrolled_args(sc, *grid(size, dev), kw), size)
                   for name, sc, size, kw in vag_cases]
    value_cases.append((PROXY_1200_NAME, *unrolled_args(city_slice(24, dev), *grid(1024, dev),
                                                        o1), 1024))
    value_cases.append(("line of sight of the Fermat orders 0-1 map", *fermat_los(dev, 1024),
                        1024))
    for name, args, kkw, size in value_cases:
        before = (pmk.LAUNCHES["power_map_value"], pmk.TWIN_LAUNCHES["power_map_value_seq"])
        v, tv = pmk.value(*args, **kkw), pmk.twin_value(*args, **kkw)
        check((pmk.LAUNCHES["power_map_value"], pmk.TWIN_LAUNCHES["power_map_value_seq"])
              == (before[0] + 1, before[1] + 1), f"{name}: the value kernel or its twin did not run")
        check(twin_equal(v, tv), f"{name} {size}^2: power_map_value != power_map_value_seq at"
                                 f" {int((v != tv).sum())} pixels")
        print(f"  {name} {size}^2: power_map_value == power_map_value_seq, torch.equal"
              f" ({v.numel()} pixels, {int((v != 0).sum())} nonzero)", flush=True)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s", flush=True)


PROXY_1200_NAME = "city slice, 24 walls (stream proxy 1,176)"


def city_slice(n_walls: int, device):
    """The first ``n_walls`` walls of ``Scene.city_scene()`` (four a
    building, a column of buildings first) with its transmitter and
    receiver.  At order 1 the stream proxy is ``W + 2 W^2``: 24 walls give
    1,176, just under the unrolled value route's 1,200."""
    from differt2d_tpu_torch import Scene

    city = Scene.city_scene(device=device)
    return Scene.from_arrays(city.walls[:n_walls], transmitters=dict(city.transmitters),
                             receivers=dict(city.receivers), device=device)


def unrolled_args(sc, X, Y, kw):
    """``(args, kernel kw)`` of the unrolled wrappers for ``power_map(sc, X,
    Y, **kw)``."""
    import torch

    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import power_map_kernel as pmk

    o = {**tr._OPTIONS, **kw}
    groups = tr._groups_for(sc, o)
    sig = o["function"] is sigmoid
    target = sc.swap_ends() if o["on_transmitters"] else sc
    txs = torch.stack(list(target.transmitters.values())).contiguous()
    inputs = pmk.kernel_inputs(groups, X.device, approx=o["approx"], sigmoid=sig)
    args = (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), txs, sc.walls, sc.kind,
            sc.phi, tuple(o[n] for n in tr._SCALAR_NAMES), inputs)
    return args, dict(approx=o["approx"], sigmoid=sig)


def fermat_los(dev, n: int):
    """``(args, kernel kw)`` of the line-of-sight group of phase 11's Fermat
    map of ``Scene.square_scene()`` at orders 0-1 (100 steps, key 1234) on
    the ``n`` x ``n`` grid: the inputs the solver route gives
    ``power_map_value``."""
    from differt2d_tpu_torch import Scene, prng
    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.ops import opt_solver_kernel as osk

    sq = Scene.square_scene()
    o = {**tr._OPTIONS, "order": None, "min_order": 0, "max_order": 1, "solver": "fermat",
         "steps": 100, "approx": True, "key": prng.PRNGKey(1234)}
    X, Y = city_grid(n, dev)
    args = osk.solver_request(sq, X, Y, tr._groups_for(sq, o), **tr._solver_options(o))
    check(args[-1].los is not None, "the Fermat orders 0-1 map has no line-of-sight group")
    return (*args[:-1], args[-1].los), dict(approx=True, sigmoid=False)


ROUTER_SCENES = ((12, 1), (16, 1), (24, 1), (28, 1), (7, 2), (60, 1), (120, 1))
"""Phase 21's scenes: ``(walls, order)``; walls from ``city_slice`` (7 at
order 2: the basic scene; 120, the whole of ``city_scene``).  Stream proxies
300, 528, 1,176, 1,596, 987, 7,260 and 28,920: they bracket the gradient
route's 400 and the value route's 1,200, and reach past the crossover."""


def value_router_phase(dev) -> None:
    """Phase 21: the redesigned power_map_value against its twin in turns on
    the Fermat map's line-of-sight group, the scene at the top of the value
    route and the basic scene at order 2, all at 1024 x 1024; then the
    router record: the unrolled kernels (B1, B2) against the looped route
    (table build and kernel) on scenes whose stream proxy brackets 400 and
    1,200, each pair held against each other within rtol 1e-4 / atol 1e-5
    (the gradients under the kink contract)."""
    from differt2d_tpu_torch import Scene
    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.ops import power_map_kernel as pmk
    from differt2d_tpu_torch.ops import power_map_looped as pml

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    X, Y = grid(1024, dev)
    o1, o2 = dict(max_order=1, approx=True), dict(max_order=2, approx=True)
    for name, (args, kkw) in (
            ("line of sight of the Fermat orders 0-1 map", fermat_los(dev, 1024)),
            (PROXY_1200_NAME, unrolled_args(city_slice(24, dev), X, Y, o1)),
            ("basic scene, order 2 (stream proxy 987)",
             unrolled_args(Scene.basic_scene(), X, Y, o2))):
        ms, twin_ms, turns = twin_times(lambda: pmk.value(*args, **kkw),
                                        lambda: pmk.twin_value(*args, **kkw), 32, 5)
        print(f"  power_map_value, {name} 1024^2: {ms:.4f} ms/map against power_map_value_seq"
              f" {twin_ms:.4f} (turns twin, new, new, twin: {', '.join(f'{x:.4f}' for x in turns)})"
              f" [{card}]", flush=True)

    print(f"router record, 1024^2, ms/map [{card}]: unrolled kernel | looped kernel | looped"
          f" table build + kernel", flush=True)
    for n_walls, order in ROUTER_SCENES:
        sc = Scene.basic_scene() if order == 2 else city_slice(n_walls, dev)
        kw = dict(max_order=order, approx=True)
        o = {**tr._OPTIONS, **kw}
        groups = tr._groups_for(sc, o)
        proxy = tr.stream_proxy(groups, sc.num_objects)
        args, kkw = unrolled_args(sc, X, Y, kw)
        cull, shadow = tr._looped_gates(sc, o, groups)
        inputs = pml.looped_inputs(groups, dev, approx=True, sigmoid=False)

        def plan():
            return pml.make_plan(X, Y, args[2], sc.walls, sc.kind, args[6], inputs, approx=True,
                                 sigmoid=False, cull=cull, shadow=shadow)

        la = (*args[:2], sc.walls, sc.kind, sc.phi, args[6], inputs)
        p0 = plan()
        for grad in (False, True):
            unrolled = (lambda: pmk.value_and_grad(*args, **kkw)) if grad else (
                lambda: pmk.value(*args, **kkw))
            looped = pml.value_and_grad if grad else pml.value
            u, lo = unrolled(), looped(*la, p0, **kkw)
            if grad:
                assert_close(f"proxy {proxy} vag value, unrolled vs looped", u[0], lo[0])
                assert_kinks(f"proxy {proxy} vag gradient, unrolled vs looped", u[1], lo[1])
            else:
                assert_close(f"proxy {proxy} value, unrolled vs looped", u, lo)
            t_u = cuda_time_ms(unrolled, 8, 5)
            t_k = cuda_time_ms(lambda: looped(*la, p0, **kkw), 8, 5)
            t_e = cuda_time_ms(lambda: looped(*la, plan(), **kkw), 8, 5)
            route = tr._route(sc, o, groups, "auto", grad=grad)
            print(f"  {n_walls} walls, order {order}, stream proxy {proxy},"
                  f" {'value + gradient' if grad else 'value'} (routed to"
                  f" {'unrolled' if route == 'cuda' else route} today): {t_u:.4f} | {t_k:.4f} |"
                  f" {t_e:.4f}; the {'unrolled' if t_u <= t_e else 'looped'} route is faster",
                  flush=True)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)


def short_wall_scene(device):
    """``Scene.basic_scene()`` with three walls of lengths 2^-100, 2^-115 and
    2^-124 at the origin (their blocked tests have |den| from about 2^-101
    down into the subnormals, below the rejection's 2^-90) and one of zero
    length at (1, 1)."""
    import numpy as np

    from differt2d_tpu_torch import Scene

    basic = Scene.basic_scene(device=device)
    w = basic.walls.cpu().numpy()
    short = np.array([[[0, 0], [2.0 ** -100, 2.0 ** -101]], [[0, 0], [2.0 ** -115, 2.0 ** -116]],
                      [[0, 0], [2.0 ** -124, 2.0 ** -125]], [[1, 1], [1, 1]]], np.float32)
    return Scene.from_arrays(np.concatenate([w, short]),
                             transmitters={"tx": basic.transmitters["tx"].cpu().numpy()},
                             receivers={"rx": [0.5, 0.5]}, device=device)


# Operations of an order-1 Fermat/MPT solve per pixel and candidate, counted
# as OPS_* above (selects, compares, min/max and negations free; values that
# do not depend on the pixel, such as the bias corrections 1 - b**count,
# once per launch): the objective and its derivative in the wall parameter
# in closed form, and one adam step.
OPS_STEP = {
    ("fermat", 0): 30, ("fermat", 1): 30,  # bounce 4, two |v + eps| 16, sum 1, derivative 9
    ("mpt", 0): 65,    # bounce 4, two unit vectors 16, reflect 8, |e|^2 5; derivative 32
    ("mpt", 1): 42,    # bounce 4, unit vector 8, sin/cos 6, |e|^2 5; derivative 19
}
OPS_ADAM = 15        # moments 7, two bias divisions 2, sqrt(v + eps_root) + eps 3, step 3
OPS_SOLVED_BOUNCE = 4  # the bounce point of the solution


def solver_ops(cands, kinds: tuple, objective: str, steps: int, n_tx: int) -> tuple[int, int]:
    """``(per pixel, per launch)`` operations of the solver kernel's map of
    the order-1 candidates ``cands``: the solve, then the validity and power
    of ``cand_ops`` with the solved bounce in place of the image step (and,
    for MPT, the solve's last loss in place of the residual)."""
    per_pixel = 0
    for row in cands:
        w = int(row[0])
        k = kinds[w]
        f, tested, _ = cand_ops([w], kinds, False)
        f += OPS_SOLVED_BOUNCE - OPS_BOUNCE - (OPS_LOSS[k] if objective == "mpt" else 0)
        per_pixel += steps * (OPS_STEP[objective, k] + OPS_ADAM) + f + OPS_TEST * tested
    per_launch = OPS_PER_WALL * len(kinds) + 2 * steps
    return per_pixel * n_tx + (n_tx - 1), per_launch * n_tx


def assert_flips(name, got, ref, bound=0.005, flip_tol=0.05, rest_tol=1e-3) -> float:
    """The MPT flip contract (PARITY.md, ``tests/test_pallas.py``): at most
    ``bound`` of the pixels beyond ``flip_tol * (1 + |ref|)``, every other
    within ``rest_tol`` relative."""
    import torch

    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = (got - ref).abs()
    scale = 1.0 + ref.abs()
    flipped = err > flip_tol * scale
    rate = float(flipped.float().mean())
    rest = float((err[~flipped] / scale[~flipped]).max()) if bool((~flipped).any()) else 0.0
    check(rate <= bound and rest <= rest_tol,
          f"{name}: {rate:.4%} of pixels flipped (bound {bound:.1%}), the others within {rest:.3g}"
          f" relative (bound {rest_tol:g})")
    print(f"  {name}: {int(flipped.sum())} flipped pixels ({rate:.4%}, bound {bound:.1%}),"
          f" others within {rest:.3g} relative; max abs err {float(err.max()):.3g};"
          f" {int((got != ref).sum())} elements differ", flush=True)
    return float(err.max())


def solver_phases(dev, peak_fp32: float) -> list:
    """Phases 11-14: the order-1 Fermat/MPT solver path (RIS map and wall
    solves of ``square_scene``, the solver kernel with the unrolled one for
    the line of sight)."""
    import math

    import torch

    from differt2d_tpu_torch import Scene, eager, power_map, prng
    from differt2d_tpu_torch import tracer as tr
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import opt_solver_kernel as osk
    from differt2d_tpu_torch.ops import power_map_kernel as pmk

    key = prng.PRNGKey(1234)
    square = Scene.square_scene()
    ris = square.add_ris([[0.5, 0.3], [0.5, 0.7]], phi=math.pi / 4)
    ris_only = lambda o: o.kind == 1  # noqa: E731
    soft = dict(approx=True, key=key)
    maps = [  # (name, scene, power_map options, contract)
        ("RIS MPT 1000 steps", ris,
         dict(order=1, solver="mpt", steps=1000, filter_objects=ris_only, **soft), "mpt"),
        ("walls Fermat", square, dict(order=1, solver="fermat", steps=100, **soft), "fermat"),
        ("walls MPT", square, dict(order=1, solver="mpt", steps=100, **soft), "mpt"),
        ("walls Fermat orders 0-1", square,
         dict(min_order=0, max_order=1, solver="fermat", steps=100, **soft), "fermat"),
    ]

    def request(sc, X, Y, kw):
        """The wrapper's inputs for ``power_map(sc, X, Y, **kw)``."""
        o = {**tr._OPTIONS, **kw}
        groups = tr._groups_for(sc, o)
        check(tr._route(sc, o, groups, "auto", grad=False) == "solver",
              "the request does not route to the solver kernel")
        opts = tr._solver_options(o)
        args = osk.solver_request(sc, X, Y, groups, **opts)
        return args, dict(approx=opts["approx"], sigmoid=opts["sigmoid"]), groups

    def compare(name, contract, got, ref):
        if contract == "mpt":
            return assert_flips(name, got, ref)
        return assert_close(name, got, ref, dict(rtol=1e-3, atol=1e-4))

    # -- 11. the solver path at full size ---------------------------------------------------
    n = 1024
    X, Y = city_grid(n, dev)
    traced = []
    trace_group = eager._trace_group
    eager._trace_group = lambda *a, **k: traced.append(1) or trace_group(*a, **k)
    launches, outs = {}, {}
    for name, sc, kw, _ in maps:
        osk.reset_launches()
        pmk.reset_launches()
        Z = power_map(sc, X, Y, **kw)
        torch.cuda.synchronize()
        launches[name] = (dict(osk.LAUNCHES), dict(pmk.LAUNCHES))
        outs[name] = Z
        print(f"solver path, {name}: launches {launches[name]}", flush=True)
        check(launches[name][0]["opt_solver_value"] >= 1, f"{name}: opt_solver_value did not run")
        los = kw.get("min_order", 1) == 0
        check((launches[name][1]["power_map_value"] >= 1) == los,
              f"{name}: power_map_value ran {launches[name][1]['power_map_value']} times for the"
              f" line of sight")
        check(Z.shape == X.shape and bool(torch.isfinite(Z).all()), f"{name}: bad map")
        check(float(Z.sum()) > 0.0, f"{name}: the map is all zero")
    eager._trace_group = trace_group
    check(not traced, "the solver path ran the eager tracer")

    err, plain_ms, reqs = {}, {}, {}
    for name, sc, kw, contract in maps:
        args, kkw, groups = request(sc, X, Y, kw)
        reqs[name] = (args, kkw, groups, sc, kw)
        got = osk.value(*args, **kkw)
        ref, plain_ms[name] = timed(lambda: osk.plain_opt_value(*args))
        err[name] = compare(f"{name} 1024^2, kernel vs plain", contract, got, ref)
        full = got
        if args[-1].los is not None:
            # The line-of-sight group on this request's inputs: the unrolled
            # kernel against its plain version, and the whole map against
            # the eager map of the whole request.
            los_args = (*args[:-1], args[-1].los)
            los = pmk.value(*los_args, **kkw)
            assert_close(f"{name} line of sight 1024^2, power_map_value vs plain", los,
                         pmk.plain_value(*los_args))
            full = got + los
            whole = eager.eager_value(torch.stack(args[:2], dim=-1), *args[2:7], args[-1].eager)
            compare(f"{name} 1024^2, both kernels vs the eager map", contract, full, whole)
        check(torch.equal(outs[name].reshape(-1), full),
              f"{name}: power_map's output differs from the wrappers' on the same inputs")
        print(f"  {name}: plain {plain_ms[name]:.1f} ms (one call)", flush=True)

    # -- 12. coverage at 256^2 ---------------------------------------------------------------
    m = 256
    Xs, Ys = city_grid(m, dev)
    fermat = dict(order=1, solver="fermat", steps=100, **soft)
    cases = [
        ("hard logic MPT", square, dict(order=1, solver="mpt", steps=100, approx=False, key=key),
         "mpt"),
        ("sigmoid, orders 0-1", square, dict(fermat, order=None, min_order=0, max_order=1,
                                             function=sigmoid), "fermat"),
        ("two TX", square.update_transmitters(tx2=[0.8, 0.3]), fermat, "fermat"),
        ("TX grid", square, dict(fermat, on_transmitters=True), "fermat"),
    ]
    for name, sc, kw, contract in cases:
        before = osk.LAUNCHES["opt_solver_value"]
        got = power_map(sc, Xs, Ys, **kw)
        check(osk.LAUNCHES["opt_solver_value"] > before, f"{name}: the solver kernel did not run")
        rsc, rkw = sc, kw
        if kw.get("on_transmitters"):
            rsc, rkw = sc.swap_ends(), {**kw, "on_transmitters": False}
        ref = power_map(rsc, Xs, Ys, backend="torch", **rkw)
        compare(f"{name} 256^2", contract, got, ref)

    # -- 13. autograd through SolverMapFunction -------------------------------------------
    # At 100 steps d(sum)/dphi is finite; at the map's 1000 it grows to about
    # 1e20 through pixels whose solve has not settled.  Both routes take the
    # eager solve's VJP, so this holds the wiring, not the gradient's value.
    Xa, Ya = city_grid(64, dev)
    kw = {**maps[0][2], "steps": 100}

    def phi_grad(backend):
        phi = ris.phi.detach().clone().requires_grad_(True)
        sc = Scene.from_arrays(ris.walls, ris.kind, phi, ris.transmitters, ris.receivers)
        out = power_map(sc, Xa, Ya, backend=backend, **kw)
        return out, torch.autograd.grad(out.sum(), phi)[0]

    before = osk.LAUNCHES["opt_solver_value"]
    got = phi_grad("auto")
    check(osk.LAUNCHES["opt_solver_value"] > before, "autograd: the solver kernel did not run")
    ref = phi_grad("torch")
    check(bool(torch.isfinite(got[1]).all()), "solver autograd: non-finite d/dphi")
    for name, a, b in zip(("value", "d/dphi"), got, ref):
        assert_close(f"solver autograd {name}", a, b)
    print(f"autograd through the solver kernel ok: d(sum)/dphi = {float(got[1][-1]):.6g}"
          f" (eager {float(ref[1][-1]):.6g})", flush=True)

    # -- 14. timing ---------------------------------------------------------------------------
    rows = []
    P = n * n
    k, reps = 8, 5
    for name, sc, kw, _ in maps:
        args, kkw, groups, sc, kw = reqs[name]
        inputs = args[-1]
        before = osk.LAUNCHES["opt_solver_value"]
        # The redesign against its twin, in turns.
        ms, twin_ms, turns = twin_times(lambda: osk.value(*args, **kkw),
                                        lambda: osk.twin_value(*args, **kkw), k, reps)
        per_map = (osk.LAUNCHES["opt_solver_value"] - before) / (2 * (k * reps + 1))
        e2e = cuda_time_ms(lambda: power_map(sc, X, Y, **kw), k, reps)
        print(f"opt_solver_value, {name} 1024^2: redesigned {ms:.4f} ms/map against its"
              f" sequential twin opt_solver_value_seq {twin_ms:.4f} ms/map (turns twin, new,"
              f" new, twin: {', '.join(f'{x:.4f}' for x in turns)})", flush=True)
        solver_issue_bound(osk, inputs, len(sc.kinds), pmk._soft_mode(kkw["approx"],
                           kkw["sigmoid"]), name.startswith("RIS"), P, name)
        ops_px, ops_launch = solver_ops(groups[1], sc.kinds, inputs.objective, inputs.steps,
                                        args[2].shape[0])
        bytes_moved = P * 12 + 4 * inputs.bc.numel()
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = (P * ops_px + ops_launch) / peak_fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"opt_solver_value, {name} 1024^2: {ms:.4f} ms/map ({P / ms * 1e3:.4g} points/s,"
              f" {per_map:g} launches/map); end to end power_map {e2e:.4f} ms/map; bound"
              f" {bound_ms:.4f} ms ({ops_px} ops/px), {bound_ms / ms:.1%} of the kernel's time;"
              f" plain {plain_ms[name]:.1f} ms/map (one call)", flush=True)
        if name == maps[0][0]:
            rows.append({
                "name": "opt_solver_value", "route": "cuda", "source": SOLVER_SOURCE,
                "replaces": SOLVER_REPLACES,
                "launches": launches[name][0]["opt_solver_value"], "max_abs_err": err[name],
                "ms": ms, "twin_ms": twin_ms, "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            })
    print("library_ms: null -- no single PyTorch call computes the solve", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
