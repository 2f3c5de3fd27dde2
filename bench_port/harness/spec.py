"""A cell of ``BENCHMARK.json``, resolved by name to its files.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json`` through the configuration's ``file`` entry;
* ``traffic/<traffic>.json``: the parameters of the one generator;
* ``checks/<cell>.json``: what the correctness comparison samples and the
  limit of each number it compares;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: tuple  # the cell's end-to-end metric entries
    per_layer: tuple   # the cell's per-layer metric entries
    bench_dir: str     # the folder its files were read from


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with no
    ``workloads`` key, everywhere its end-to-end metric is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(root: str, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        msg = f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})"
        raise KeyError(msg)
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    checks = _load_json(os.path.join(bench_dir, "checks", f"{name}.json"))
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, name, set()))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"] if _applies(m, name, reported))
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                checks=checks, end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
