"""Tuning of the looped kernels' culling tile and refine, run once on a GPU.

Run from the root of a checkout, with one CUDA device:

    python -m differt2d_tpu_torch.ops.looped_tuning [--order 2]
    python -m differt2d_tpu_torch.ops.looped_tuning --census

For the city extract (136 walls, soft logic, hard_sigmoid, alpha 100) on a
1024 x 1024 grid, at orders <= 1 (the default) or <= 2, it prints:

* a ``torch.profiler`` trace of one end-to-end ``power_map``: the device
  time in kernel launches against the host clock (the card's idle share),
  and the largest kernels;
* for each (tile, refine) of :data:`SWEEP` (order <= 1) or
  :data:`SWEEP_ORDER2`: the table build and the culled value kernel per map
  (CUDA events, maps chained, median of 3), and the share of each order's
  candidate-pixels the tables keep.

With ``--census`` it prints instead the redesign's measurements
(:func:`census_and_twins`): the looped program's ``ptxas`` report, the
per-tile work histogram and schedule makespans, the share of listed
blocked tests the rejection skips, and the redesigned kernels against
their sequential twins (orders <= 1 and <= 2).

These sweeps chose :data:`power_map_looped.TILE` and the refine of
:func:`power_map_looped.refine_for` (PERF.md, Findings).  Each sweep point
sets its refine by patching :func:`power_map_looped.refine_for`: the library
itself has no refine option.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

SWEEP = (((16, 8), 4), ((16, 16), 4), ((32, 8), 4), ((8, 32), 4), ((16, 16), 2),
         ((16, 16), 8))
"""``((tile columns, tile rows), refine)`` points of the order <= 1 sweep."""
SWEEP_ORDER2 = (((16, 16), 1), ((16, 16), 2), ((16, 16), 4), ((16, 16), 8), ((16, 16), 16))
"""The same for order <= 2 (refine 16 is timed on one map: its build takes
seconds)."""


def cuda_time_ms(fn, k: int, reps: int) -> float:
    """Median over ``reps`` of the mean ms per call of ``k`` chained calls."""
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


def profile_one_map(city, X, Y, kw) -> None:
    """Device time of one end-to-end city map against its host clock."""
    from torch.profiler import ProfilerActivity, profile

    from .. import power_map

    power_map(city, X, Y, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        power_map(city, X, Y, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel-level events only: the operator-level ones repeat their time.
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile of one city map {X.shape[0]}^2: {wall_ms:.3f} ms on the host clock,"
          f" {device_ms:.3f} ms of device time in {sum(e.count for e in kernels)} kernel"
          f" launches ({1 - device_ms / wall_ms:.1%} idle)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)


def main(n: int = 1024, order: int = 1) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("looped_tuning needs a CUDA device")
    from .. import Scene
    from .. import tracer as tr
    from . import power_map_looped as pml

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    city = Scene.city_extract_scene(device=dev)
    x = torch.linspace(0.01, 0.99, n, device=dev)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    kw = dict(max_order=order, approx=True)
    profile_one_map(city, X, Y, kw)

    o = {**tr._OPTIONS, **kw}
    inputs = pml.looped_inputs(tr._groups_for(city, o), dev, approx=True, sigmoid=False)
    txs = torch.stack(list(city.transmitters.values())).contiguous()
    scal = tuple(o[name] for name in tr._SCALAR_NAMES)
    px, py = X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    for tile, refine in (SWEEP if order <= 1 else SWEEP_ORDER2):
        def replan(tile=tile):
            return pml.make_plan(X, Y, txs, city.walls, city.kind, scal, inputs, approx=True,
                                 sigmoid=False, tile=tile)

        k, reps = (1, 1) if refine >= 16 else (4 if order <= 1 else 2, 3)
        with mock.patch.object(pml, "refine_for", lambda num_candidates, r=refine: r):
            t_build = cuda_time_ms(replan, k, reps)
            plan = replan()
        t_run = cuda_time_ms(lambda: pml.value(px, py, city.walls, city.kind, city.phi, scal,
                                               inputs, plan, approx=True, sigmoid=False), k, reps)
        tb = plan.per_tx[0].tables
        kept = ", ".join(f"order {o}: {float(c.sum()) / p.numel():.2%}"
                         for o, p, c in zip(inputs.orders, tb.prm, tb.cnt))
        print(f"tile {tile[0]}x{tile[1]} refine {refine}: tables {t_build:.4f} + kernel"
              f" {t_run:.4f} = {t_build + t_run:.4f} ms/map; kept {kept}", flush=True)
        del plan
        torch.cuda.empty_cache()
    return 0


def makespan(tests: torch.Tensor, slots: int, longest_first: bool) -> float:
    """Finishing time, in blocked tests, of the tiles' work on ``slots``
    resident blocks, each tile going to the slot that frees first: in index
    order (one block per tile in grid order) or longest first."""
    import heapq

    work = sorted(tests.tolist(), reverse=True) if longest_first else tests.tolist()
    free = [0.0] * slots
    for w in work:
        heapq.heapreplace(free, free[0] + w)
    return max(free)


def sweep_census(city, X, Y, plan, inputs, scal, tiles, grad: bool) -> dict:
    """What the redesigned sweep does on the tiles ``tiles`` of ``plan``:
    every kept candidate of each tile, every segment against its listed,
    non-vertex, non-adjacent walls, the numerators formed as the kernels
    form them (``seg_margin``) from the plain tracer's bounce points.
    Returns the counts ``listed`` (tests), ``rejected`` (by
    :func:`power_map_looped.rejects` against this map's bounds), and the
    same two over the candidate-pixels whose on-object and loss gates are
    live (``live``, ``live_rejected``: the only ones whose sweep the kernels
    run; the plain tracer's gates, so a count, not a bit-exact replay)."""
    from .. import eager
    from ..logic import hard_sigmoid
    from . import cull_tables
    from . import power_map_looped as pml

    alpha, tol = float(scal[0]), float(scal[1])
    tlo, thi, _ = pml.rejection_bounds(alpha, 1, grad)
    W = city.walls.shape[0]
    tp = plan.per_tx[0]
    tb = tp.tables
    solid = city.kind != 2
    other = ~torch.eye(W, dtype=torch.bool, device=X.device)
    l0 = cull_tables.unpack_words(tb.l0w, W)
    last = cull_tables.unpack_words(tb.lastw, W)
    los = cull_tables.unpack_words(tb.losw, W)
    mid = cull_tables.unpack_words(tb.midw, W).reshape(W, W, W) if tb.midw.numel() else None
    pa, pb = tp.aux[:, 2:4], tp.aux[:, 4:6]
    av = pb - pa
    out = dict(listed=0, rejected=0, live=0, live_rejected=0)
    tx = tp.tx.reshape(1, 1, 2)
    for t in tiles:
        tw, th = plan.tile
        r, c = divmod(int(t), plan.tiles[0])
        xs = X[r * th:(r + 1) * th, c * tw:(c + 1) * tw].reshape(-1)
        ys = Y[r * th:(r + 1) * th, c * tw:(c + 1) * tw].reshape(-1)
        rx = torch.stack([xs, ys], dim=-1).reshape(-1, 1, 2)
        groups = [(0, None, None)] if inputs.has_los else []
        groups += [(o, cand, (prm, cnt)) for (o, cand), prm, cnt in
                   zip(inputs.cands, tb.prm, tb.cnt)]
        for o, cand, lists in groups:
            if o == 0:
                pts = torch.cat([tx.expand(rx.shape[0], 1, 2)[:, :, None], rx[:, :, None]],
                                dim=2)
                segs = [los[t][None, :] & solid]
                live = torch.ones(pts.shape[:2], dtype=torch.bool, device=X.device)
            else:
                keep = lists[0][t, :int(lists[1][t])].long()
                if keep.numel() == 0:
                    continue
                w = cand[keep].long()
                cw, ck = city.walls[w], city.kind[w]
                b = eager._solve_image(tx, rx, cw, ck)
                P, C = b.shape[:2]
                pts = torch.cat([tx.expand(P, C, 2)[:, :, None], b,
                                 rx.expand(P, C, 2)[:, :, None]], dim=2)
                on = eager._on_objects(b, cw, ck, True, alpha, hard_sigmoid)
                loss = eager._bounce_residuals(pts, cw, ck, city.phi[w])
                live = (on > 0) & (hard_sigmoid(tol - loss, alpha) > 0)
                segs = [l0[w[:, 0]] & other[w[:, 0]]]
                segs += [mid[w[:, s - 1], w[:, s]] & other[w[:, s - 1]] & other[w[:, s]]
                         for s in range(1, o)]
                segs.append(last[t][w[:, -1]] & other[w[:, -1]])
                segs = [m & solid for m in segs]
            for s, m in enumerate(segs):
                cpt, dpt = pts[:, :, s, None, :], pts[:, :, s + 1, None, :]
                bv = cpt - dpt
                cv = pa - cpt
                num_a = bv[..., 1] * cv[..., 0] - bv[..., 0] * cv[..., 1]
                num_b = av[:, 0] * cv[..., 1] - av[:, 1] * cv[..., 0]
                den = av[:, 1] * bv[..., 0] - av[:, 0] * bv[..., 1]
                mask = m[None].expand_as(den)
                rej = pml.rejects(num_a, num_b, den, tlo, thi) & mask
                lv = live[..., None]
                out["rejected"] += int(rej.sum())
                out["listed"] += int(mask.sum())
                out["live_rejected"] += int((rej & lv).sum())
                out["live"] += int((mask & lv).sum())
    return out


def census_and_twins(n: int = 1024, orders=(1, 2)) -> int:
    """The redesign's measurements on one card: the ``ptxas`` report of the
    looped program (both sweeps), the per-tile blocked-test histogram with
    the last-wave makespan of grid order and of longest-first, the share of
    listed tests the rejection skips, and the redesigned kernels timed
    against their sequential twins in turns (twin, new, new, twin) with
    ``torch.equal`` on their outputs, then with each part of the redesign
    switched off in turn (:data:`power_map_looped.ABLATIONS`) and with all
    four off."""
    from .. import Scene
    from .. import tracer as tr
    from . import _build
    from . import power_map_looped as pml

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    path, secs = _build.build(pml.SOURCE)
    print(f"build {pml.SOURCE}: {secs:.1f} s", flush=True)
    for line in _build.BUILD_LOG.get(pml.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  ptxas:", line.strip(), flush=True)
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"sigmoid bands hold on the card: {pml.sigmoid_bands(dev)}", flush=True)
    city = Scene.city_extract_scene(device=dev)
    x = torch.linspace(0.01, 0.99, n, device=dev)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    px, py = X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    for order in orders:
        kw = dict(max_order=order, approx=True)
        o = {**tr._OPTIONS, **kw}
        inputs = pml.looped_inputs(tr._groups_for(city, o), dev, approx=True, sigmoid=False)
        txs = torch.stack(list(city.transmitters.values())).contiguous()
        scal = tuple(o[name] for name in tr._SCALAR_NAMES)
        plan = pml.make_plan(X, Y, txs, city.walls, city.kind, scal, inputs, approx=True,
                             sigmoid=False)
        tests = pml.tile_tests(plan.per_tx[0].tables, inputs, city.kind).double()
        T = tests.numel()
        q = torch.quantile(tests, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                               device=dev)).tolist()
        print(f"order <= {order}, {n}^2: {T} tiles, blocked tests per tile: mean"
              f" {float(tests.mean()):.1f}, median {q[0]:.0f}, p90 {q[1]:.0f}, p99 {q[2]:.0f},"
              f" max {float(tests.max()):.0f} (max/mean {float(tests.max() / tests.mean()):.2f})",
              flush=True)
        for per_sm in (2, 4, 6):
            slots = sms * per_sm
            ideal = float(tests.sum()) / slots
            grid_ms = makespan(tests.cpu(), slots, False)
            lpt_ms = makespan(tests.cpu(), slots, True)
            print(f"  {slots} resident blocks: makespan grid order {grid_ms / ideal:.3f} x ideal,"
                  f" longest first {lpt_ms / ideal:.3f} x ideal", flush=True)
        sample = list(range(0, T, max(1, T // 32)))
        for grad in (False, True):
            c = sweep_census(city, X, Y, plan, inputs, scal, sample, grad)
            print(f"  {'vag' if grad else 'value'} sweep on {len(sample)} tiles: rejected"
                  f" {c['rejected']} of {c['listed']} listed tests"
                  f" ({c['rejected'] / max(c['listed'], 1):.2%}); gates live for"
                  f" {c['live'] / max(c['listed'], 1):.2%} of them, of which"
                  f" {c['live_rejected'] / max(c['live'], 1):.2%} rejected", flush=True)
        args = (px, py, city.walls, city.kind, city.phi, scal, inputs, plan)
        kk = dict(approx=True, sigmoid=False)
        k = 4 if order <= 1 else 2
        for name, new, twin in (("value", pml.value, pml.twin_value),
                                ("vag", pml.value_and_grad, pml.twin_value_and_grad)):
            a, b = new(*args, **kk), twin(*args, **kk)
            if isinstance(a, tuple):
                same = all(torch.equal(u, v) for u, v in zip(a, b))
            else:
                same = torch.equal(a, b)
            times = [cuda_time_ms(lambda f=f: f(*args, **kk), k, 3)
                     for f in (twin, new, new, twin)]
            print(f"  {name} order <= {order} {n}^2: torch.equal(new, twin) {same}; ms twin"
                  f" {times[0]:.4f}, new {times[1]:.4f}, new {times[2]:.4f}, twin {times[3]:.4f}",
                  flush=True)
            grad = name == "vag"
            for off in (*((p,) for p in pml.ABLATIONS), pml.ABLATIONS):
                def ablated(off=off):
                    out = torch.zeros_like(px)
                    gout = torch.zeros(px.numel(), 2, device=dev) if grad else None
                    pml._launch(f"power_map_looped_{name}", *args, approx=True, sigmoid=False,
                                out=out, gout=gout, counts={f"power_map_looped_{name}": 0},
                                ablate=off)
                    return (out, gout) if grad else out

                got = ablated()
                same = (all(torch.equal(u, v) for u, v in zip(got, a)) if grad
                        else torch.equal(got, a))
                t = [cuda_time_ms(f, k, 3) for f in (lambda: new(*args, **kk), ablated,
                                                     ablated, lambda: new(*args, **kk))]
                print(f"    without {'+'.join(off)}: {(t[1] + t[2]) / 2:.4f} ms against"
                      f" {(t[0] + t[3]) / 2:.4f} ms with it (turns {', '.join(f'{x:.4f}' for x in t)});"
                      f" equal bits {same}", flush=True)
        del plan
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if "--census" in sys.argv:
        sys.exit(census_and_twins())
    sys.exit(main(order=int(sys.argv[sys.argv.index("--order") + 1]) if "--order" in sys.argv
                  else 1))
