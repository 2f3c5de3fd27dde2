"""No module the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "differt2d_tpu"}


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list:
    out = []
    for dirpath, dirnames, files in os.walk(os.path.join(BENCH_DIR, sub)):
        dirnames[:] = [d for d in dirnames if d not in ("tests", "__pycache__")]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_benchmark_imports_no_jax():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for sub in ("reference", "roofline"):
        for path in _sources(sub):
            assert "differt2d_tpu_torch" not in _imports(path), path
            assert not (_imports(path) & FORBIDDEN), path


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from harness import runner, spec\n"
        "cell = spec.load_cell(%r, 'basic-sweep')\n"
        "runner.run(cell, seed=3, seconds=0.05, trace=False, device=torch.device('cpu'),"
        " t_start=time.perf_counter(), grid_n=4)\n"
        "print(runner.forbidden_modules())\n"
    ) % (BENCH_DIR, ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
