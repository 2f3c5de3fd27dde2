"""Whole runs of the harness on the CPU at grids of a few pixels: a sound
program comes out correct, and each fault planted under the timed path, and
the control (the reference in bfloat16 in the program's place), comes out
not correct.  The control at each cell's own size runs on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, read_json

from harness import runner, spec
from harness.system import Program

CPU = torch.device("cpu")
GRID = 10
SECONDS = 0.3


class Stale(Program):
    """Answers each request with the previous request's map."""

    prev = None

    def __call__(self, tx):
        out = super().__call__(tx if self.prev is None else self.prev)
        self.prev = tx
        return out


class Half(Program):
    """Leaves the second half of the pixels out (zeros)."""

    def __call__(self, tx):
        out = super().__call__(tx)
        for t in out if isinstance(out, tuple) else (out,):
            t.view(t.shape[0], -1)[t.shape[0] // 2:] = 0
        return out


class Altered(Program):
    """Scales the strongest pixel of every map by 10%."""

    def __call__(self, tx):
        out = super().__call__(tx)
        for t in out if isinstance(out, tuple) else (out,):
            flat = t.view(-1)
            flat[flat.abs().argmax()] *= 1.1
        return out


def _run(root, name, **kw):
    cell = spec.load_cell(str(root), name, os.path.join(str(root), "bench_port"))
    return runner.run(cell, seed=kw.pop("seed", 2**31 + 11), seconds=SECONDS, trace=False,
                      device=CPU, t_start=time.perf_counter(), grid_n=kw.pop("grid_n", GRID),
                      **kw)


SOUND = ["basic-sweep", "basic-grad-sweep", "tiny-city-sweep"]


@pytest.mark.parametrize("name", SOUND)
def test_sound_run_is_correct(copy_root, name):
    res = _run(copy_root, name)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-2] == "checks"  # last once the run's own notes are popped
    assert "setup_s" in res["metrics"]
    if not name.startswith("tiny"):
        assert set(res["metrics"]) == {"points_per_s", "setup_s"}
    assert len(res["_window"].kept) >= 1


@pytest.mark.parametrize("name", ["basic-sweep", "tiny-city-sweep"])
def test_traced_run_reads_the_spans(copy_root, monkeypatch, name):
    host = "host_ms.sweep"
    bench = read_json(str(copy_root / "BENCHMARK.json"))
    for m in bench["per_layer"]:
        if m["name"] == host:
            m["workloads"].append("tiny-city-sweep")
    (copy_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(str(copy_root), name, str(copy_root / "bench_port"))
    seen, load = [], spec.metric_reader

    def reader(metric, bench_dir):
        read = load(metric, bench_dir)
        return (lambda tr: seen.append(tr) or read(tr)) if metric == host else read

    monkeypatch.setattr(spec, "metric_reader", reader)
    res = runner.run(cell, seed=5, seconds=SECONDS, trace=True, device=CPU,
                     t_start=time.perf_counter(), grid_n=GRID)
    assert res["correct"] is True
    # No card: the device readers find nothing and are left out.
    assert set(res["metrics"]) == {host}
    # The host's time comes from the untraced window before the traced
    # one, on rows of its own.
    (tr,) = seen
    spans = tr.plain.spans["power_map"]
    assert tr.plain.maps == len(spans) > 0 and tr.maps > 0
    assert res["metrics"][host]["value"] == pytest.approx(
        1e3 * sum(e - s for s, e in spans) / len(spans))
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("fault", [Stale, Half, Altered])
@pytest.mark.parametrize("name", SOUND)
def test_planted_fault_is_not_correct(copy_root, name, fault):
    res = _run(copy_root, name, program_factory=fault)
    assert res["correct"] is False


def test_wrongly_culled_candidates_are_not_correct(copy_root, monkeypatch):
    from differt2d_tpu_torch.ops import power_map_looped as pml

    build = pml.build_tables

    def drop_half(*args, **kwargs):
        tables = build(*args, **kwargs)
        cnt = tuple(c // 2 for c in tables.cnt)
        return type(tables)(**{**tables.__dict__, "cnt": cnt})

    monkeypatch.setattr(pml, "build_tables", drop_half)
    assert _run(copy_root, "tiny-city-sweep")["correct"] is False


def test_one_wrongly_culled_candidate_in_one_tile_is_not_correct(copy_root, monkeypatch):
    """The city cells' pixel rule, on the four-building city at 48 x 48
    pixels (nine 16 x 16 tiles): in the middle tile, the candidate that the
    reference finds valid at most of the tile's pixels is left off that
    tile's list alone, in every map."""
    from differt2d_tpu_torch.ops import power_map_looped as pml
    from reference import tracer as ref

    from harness import config as cfg
    from harness.system import grid_pixels

    grid, tile = 48, 4
    rule = read_json(os.path.join(ROOT, "bench_port", "checks", "city2-sweep.json"))["pixels"]
    checks = copy_root / "bench_port" / "checks" / "tiny-city-sweep.json"
    checks.write_text(json.dumps({**read_json(str(checks)), "pixels": rule}))
    config = spec.load_cell(str(copy_root), "tiny-city-sweep",
                            str(copy_root / "bench_port")).config
    px, py = grid_pixels(config, grid)
    walls = torch.as_tensor(cfg.walls(config))
    build, dropped = pml.build_tables, []

    def drop_one(walls_, kind, tx, normals, imgs, inputs, bounds, *args, **kwargs):
        tables = build(walls_, kind, tx, normals, imgs, inputs, bounds, *args, **kwargs)
        x0, x1, y0, y1 = (float(b[tile]) for b in bounds)
        inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        x, y = torch.as_tensor(px[inside]), torch.as_tensor(py[inside])
        best = (0, None, None)
        for k, ((o, cand), prm, cnt) in enumerate(zip(inputs.cands, tables.prm, tables.cnt)):
            for j in prm[tile, :int(cnt[tile])].tolist():
                z = ref.power_map(walls, tx.cpu(), x, y, cfg.request(config),
                                  cands={o: cand[j:j + 1].cpu().long()})
                best = max(best, (int((z > 0).sum()), k, j), key=lambda b: b[0])
        _, k, j = best
        if k is None:  # no path reaches the tile from this transmitter
            return tables
        prm, cnt = [p.clone() for p in tables.prm], [c.clone() for c in tables.cnt]
        n = int(cnt[k][tile])
        at = int((prm[k][tile, :n] == j).nonzero()[0])
        prm[k][tile, at], prm[k][tile, n - 1] = prm[k][tile, n - 1].item(), j
        cnt[k][tile] -= 1
        dropped.append(j)
        return type(tables)(**{**tables.__dict__, "prm": tuple(prm), "cnt": tuple(cnt)})

    assert _run(copy_root, "tiny-city-sweep", grid_n=grid)["correct"] is True
    monkeypatch.setattr(pml, "build_tables", drop_one)
    assert _run(copy_root, "tiny-city-sweep", grid_n=grid)["correct"] is False
    assert dropped


@pytest.mark.parametrize("name", SOUND)
def test_control_is_not_correct(copy_root, name):
    assert _run(copy_root, name, control_dtype=torch.bfloat16)["correct"] is False


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "basic-sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=False)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in read_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]])
def test_control_fails_at_the_cells_size(cuda_device, name):
    import calibrate

    cell = spec.load_cell(ROOT, name)
    for _, numbers, correct in calibrate.readings(cell, (101, 202, 303), 2.0, cuda_device,
                                                  control=True):
        assert not correct, numbers
