"""One run of one cell: set up, warm up, measure, trace, check, report."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import check, spec, traffic
from . import trace as tracing
from .system import Program
from .window import Spans, closed_loop

FORBIDDEN = ("jax", "jaxlib", "flax", "differt2d_tpu")
"""Top-level module names the process may not hold (compared whole)."""


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def least_seconds(cell: spec.Cell, pixels: int):
    """The least time of one map of the cell on the card (the roofline)."""
    from roofline import counts
    from reference import tracer as ref

    from . import config as cfg

    req = cfg.request(cell.config)
    cands = {o: c.tolist() for o, c in
             ref.candidates(len(cfg.walls(cell.config)), req["min_order"],
                            req["max_order"]).items()}
    kinds = (0,) * len(cfg.walls(cell.config))
    grad = bool(cell.traffic["value_and_grad"])
    ops = counts.map_ops(cands, kinds, pixels, grad)
    nbytes = counts.map_bytes(cands, len(kinds), pixels, grad)
    return counts.least_seconds(ops, nbytes)[0]


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, grid_n=None, program_factory=Program, control_dtype=None) -> dict:
    """Run the cell once; the result line's object.

    ``grid_n``, ``program_factory`` and ``control_dtype`` are for tests and
    the control: a smaller grid, a program with a planted fault, or the
    reference in a lower precision judged in the program's place.
    """
    from reference import tracer as reference

    from . import config as cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp, cfg_ = cell.traffic, cell.config
    grad = bool(tp["value_and_grad"])
    marks = {"imports": time.perf_counter() - t_start}
    program = program_factory(cfg_, device, value_and_grad=grad, grid_n=grid_n)
    marks["program"] = time.perf_counter() - t_start
    if trace:
        seconds = min(seconds, float(tp["trace_seconds"]))
    count = int(tp["rows"])
    rows = torch.as_tensor(
        traffic.positions(cfg_, tp["strata"], count, traffic.rng(seed, "rows")), device=device)
    warm = torch.as_tensor(
        traffic.positions(cfg_, tp["strata"], tp["warmup_maps"], traffic.rng(seed, "warmup")),
        device=device)
    marks["rows"] = time.perf_counter() - t_start
    for tx in warm:
        program(tx)
    _sync(device)
    least = least_seconds(cell, program.pixels) if trace else None
    maps_gen = traffic.rng(seed, "maps")
    keep = int(cell.checks["maps"])
    setup_s = time.perf_counter() - t_start

    uniforms = maps_gen.random(count)

    def window(span: Spans, keep_n: int, first: int = 0):
        return closed_loop(program, rows, seconds, int(tp["sync_every"]), keep_n, uniforms,
                           span, first)

    plain = None
    if trace:
        # The same window untraced first: the host's times and the rate.
        clock = Spans("clock")
        pwin = window(clock, 0)
        _sync(device)
        plain = tracing.Plain(maps=pwin.maps, seconds=pwin.seconds, spans=clock.clock)

    with tracing.capture(trace) as cap:
        win = window(Spans("profiler" if trace else None), keep,
                     plain.maps if plain is not None else 0)
        _sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    metrics = {}
    if not trace:
        metrics["points_per_s"] = win.maps * program.pixels / win.seconds
        metrics["setup_s"] = setup_s
    extra = {}
    if trace:
        tr = tracing.reduce(cap.events, cap.t0, cap.t1, win.maps, least, plain)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.bench_dir)(tr)
            if value is not None:
                metrics[m["name"]] = value
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = tracing.breakdown(tr)
        del tr, cap.events
    units = {m["name"]: m["unit"] for m in (*cell.end_to_end, *cell.per_layer)}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {m["name"]: {"value": metrics[m["name"]], "unit": units[m["name"]]}
               for m in wanted if m["name"] in metrics}

    # The program's state goes before the reference runs.
    xs, ys = cfg.grid_axes(cfg_, grid_n)
    shape = (len(ys), len(xs))
    kept = win.kept
    del program, rows, warm
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    pix_gen = traffic.rng(seed, "pixels")
    pairs = []
    for j in sorted(kept):
        tx, out = kept[j]
        idx = check.pixel_sample(shape, cell.checks.get("pixels"), pix_gen)
        ref = check.reference_side(reference, cfg_, tx, idx, grad=grad, device=device,
                                   grid_n=grid_n)
        if control_dtype is None:
            got = check.program_side(out, idx)
        else:
            got = check.reference_side(reference, cfg_, tx, idx, grad=grad, device=device,
                                       dtype=control_dtype, grid_n=grid_n)
        pairs.append((got, ref))
    win.reference_s = time.perf_counter() - t_ref
    win.setup_marks = {**marks, "warm": setup_s}
    found = check.numbers(pairs, grad)
    limits = cell.checks["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in found.items()}
    correct = win.failed == 0 and all(v <= limits[k] for k, v in found.items())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": peak, **extra}
    result = {"correct": bool(correct), "attempted": int(win.maps), "failed": int(win.failed),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    win.kept = {j: None for j in kept}
    result["_window"] = win
    return result


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = os.getcwd()
    if root not in sys.path:
        sys.path.insert(0, root)
    cell = spec.load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                 device=torch.device("cuda", 0), t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded: {leaked}", file=sys.stderr)
        return 3
    win = result.pop("_window")
    window = {"maps": win.maps, "seconds": win.seconds,
              "checked_maps": len(win.kept), "reference_s": win.reference_s,
              "setup_marks_s": win.setup_marks}
    print(f"card: {card_line()}; window: {json.dumps(window)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
