"""Readings of a cell's compared numbers over many seeds, in one process.

From the root of a checkout, on a machine with a card::

    python3 bench_port/calibrate.py --workload city2-sweep --seconds 3 --seeds 11 12 13
    python3 bench_port/calibrate.py --workload city2-sweep --seconds 3 --seeds 11 12 13 --control

Each seed runs the cell as ``run.py`` does, with a window of ``--seconds``,
and prints one JSON line: the compared numbers and whether the run came
out correct.  ``--control`` judges the plain reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place, on the same maps and pixels: the control's readings must
fail the limits.  The limits of ``checks/<cell>.json`` are set between the
program's largest reading and the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from harness import runner, spec  # noqa: E402


def readings(cell: spec.Cell, seeds, seconds: float, device: torch.device, *,
             control: bool, grid_n=None) -> list:
    """``[(seed, numbers, correct), ...]`` of runs of ``cell`` (the control
    in the program's place when ``control``)."""
    out = []
    for seed in seeds:
        res = runner.run(cell, seed=seed, seconds=seconds, trace=False, device=device,
                         t_start=time.perf_counter(), grid_n=grid_n,
                         control_dtype=torch.bfloat16 if control else None)
        out.append((seed, {k: c["value"] for k, c in res["checks"].items()}, res["correct"]))
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(root, args.workload)
    for seed, numbers, correct in readings(cell, args.seeds, args.seconds,
                                           torch.device("cuda", 0), control=args.control):
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "numbers": numbers, "correct": correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
