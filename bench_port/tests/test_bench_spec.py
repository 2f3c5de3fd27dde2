"""Cells resolve from their files by name; a dropped-in metric file is found;
``BENCHMARK.json`` keeps its keys, names, limits and files in shape."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import BENCH_DIR, ROOT, read_json

from harness import spec
from harness.trace import Trace

BENCH = read_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = spec.load_cell(ROOT, name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["sync_every"] >= 1
    assert set(cell.checks["limits"]) >= {"map_err"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))


def test_dropped_metric_file_is_found(copy_root):
    bench_dir = str(copy_root / "bench_port")
    (copy_root / "bench_port" / "metrics" / "spans_per_map.py").write_text(
        "def read(trace):\n    return sum(len(v) for v in trace.spans.values()) / trace.maps\n")
    bench = json.loads((copy_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "spans_per_map", "unit": "1", "better": "lower",
                               "source": "program_span", "layer": "entry and dispatch",
                               "moves": "points_per_s", "workloads": ["basic-sweep"]})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(str(copy_root), "basic-sweep", bench_dir)
    assert "spans_per_map" in [m["name"] for m in cell.per_layer]
    fake = Trace(maps=2, t0=0.0, t1=1.0, spans={"power_map": [(0, 1), (1, 2)]}, kernels=[],
                 copies=[], least_s=None)
    assert spec.metric_reader("spans_per_map", bench_dir)(fake) == 1.0


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH_DIR, "checks", f"{w['name']}.json"))
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
    assert len(json.dumps(BENCH)) <= 64 * 1024
