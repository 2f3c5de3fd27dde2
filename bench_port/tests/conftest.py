"""Fixtures of the benchmark's own tests (run from the repository root:
``python -m pytest bench_port/tests -q -p no:randomly -o addopts=""``).

Tests marked ``cuda`` need a card and skip without one; the others run the
harness on the CPU, where the program's entry points take ``device="cpu"``
and run their plain versions, at grids of a few pixels.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CITY = {
    "name": "tiny-city",
    "source": "four rectangular buildings (test scene)",
    "reduced": [],
    "assumed": [],
    "scene": {"buildings": [
        [[0.1, 0.1], [0.35, 0.1], [0.35, 0.3], [0.1, 0.3]],
        [[0.5, 0.15], [0.8, 0.15], [0.8, 0.4], [0.5, 0.4]],
        [[0.2, 0.55], [0.45, 0.55], [0.45, 0.85], [0.2, 0.85]],
        [[0.6, 0.6], [0.9, 0.6], [0.9, 0.9], [0.6, 0.9]],
    ]},
    "request": {"min_order": 0, "max_order": 2, "solver": "image", "approx": True,
                "activation": "hard_sigmoid", "alpha": 100.0, "tol": 0.01, "patch": 0.0,
                "r_coef": 0.5, "height": 0.1},
    "grid": {"n": 1024, "x": [0.01, 0.99], "y": [0.01, 0.99]},
    "transmitters": {"region": [0.01, 0.01, 0.99, 0.99], "outside_footprints": True,
                     "wall_margin": 0.001},
}


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture()
def copy_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's folder, with a
    four-building city and its cell added as files and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    (root / "bench_port" / "configs" / "tiny-city.json").write_text(json.dumps(TINY_CITY))
    bench["configs"].append({"name": "tiny-city", "source": TINY_CITY["source"],
                             "file": "bench_port/configs/tiny-city.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-city-sweep", "config": "tiny-city",
                               "traffic": "sweep-sync1", "chips": 1, "why": "test"})
    (root / "bench_port" / "checks" / "tiny-city-sweep.json").write_text(
        json.dumps({"maps": 4, "pixels": None, "limits": {"map_err": 1e-2}}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
