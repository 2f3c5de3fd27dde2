"""Tuning of the looped kernels' culling tile and refine, run once on a GPU.

Run from the root of a checkout, with one CUDA device:

    python -m differt2d_tpu_torch.ops.looped_tuning [--order 2]

For the city extract (136 walls, soft logic, hard_sigmoid, alpha 100) on a
1024 x 1024 grid, at orders <= 1 (the default) or <= 2, it prints:

* a ``torch.profiler`` trace of one end-to-end ``power_map``: the device
  time in kernel launches against the host clock (the card's idle share),
  and the largest kernels;
* for each (tile, refine) of :data:`SWEEP` (order <= 1) or
  :data:`SWEEP_ORDER2`: the table build and the culled value kernel per map
  (CUDA events, maps chained, median of 3), and the share of each order's
  candidate-pixels the tables keep.

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


if __name__ == "__main__":
    sys.exit(main(order=int(sys.argv[sys.argv.index("--order") + 1]) if "--order" in sys.argv
                  else 1))
