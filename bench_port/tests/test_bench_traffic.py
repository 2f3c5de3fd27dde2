"""The generator reproduces its draws from the seed; city transmitters stay
on the streets."""

from __future__ import annotations

import os

import numpy as np
import pytest
from conftest import BENCH_DIR, read_json

from harness import config as cfg
from harness import traffic


def _config(name: str) -> dict:
    return read_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def _inside_winding(x: float, y: float, ring) -> bool:
    """Winding-number test, written apart from the generator's even-odd one."""
    wn = 0
    for (ax, ay), (bx, by) in zip(ring, [*ring[1:], ring[0]]):
        cross = (bx - ax) * (y - ay) - (x - ax) * (by - ay)
        if ay <= y < by and cross > 0:
            wn += 1
        elif by <= y < ay and cross < 0:
            wn -= 1
    return wn != 0


@pytest.mark.parametrize("name", ["basic", "city2"])
def test_positions_reproducible_from_the_seed(name):
    config = _config(name)
    seed = 2**31 + 977
    a = traffic.positions(config, 16, 600, traffic.rng(seed, "rows"))
    b = traffic.positions(config, 16, 600, traffic.rng(seed, "rows"))
    c = traffic.positions(config, 16, 600, traffic.rng(seed + 1, "rows"))
    assert a.dtype == np.float32 and a.shape == (600, 2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a, traffic.positions(config, 16, 600, traffic.rng(seed, "warmup")))
    x0, y0, x1, y1 = config["transmitters"]["region"]
    assert np.all((a[:, 0] >= x0) & (a[:, 0] <= x1) & (a[:, 1] >= y0) & (a[:, 1] <= y1))
    margin = config["transmitters"]["wall_margin"]
    assert np.all(traffic.wall_distance(a.astype(np.float64), cfg.walls(config)) >= margin * 0.999)


def test_city_positions_outside_every_footprint():
    config = _config("city2")
    pts = traffic.positions(config, 16, 2000, traffic.rng(5, "rows"))
    rings = [r.tolist() for r in cfg.footprints(config)]
    assert len(rings) == 23
    for x, y in pts.astype(np.float64):
        assert not any(_inside_winding(x, y, r) for r in rings)
    # The generator's own test agrees with the independent one on random points.
    probe = np.random.default_rng(0).random((500, 2))
    for ring in rings:
        ours = traffic.inside(probe, np.asarray(ring))
        theirs = np.array([_inside_winding(x, y, ring) for x, y in probe])
        assert np.array_equal(ours, theirs)


def test_walls_of_the_city_are_its_rings_edges():
    walls = cfg.walls(_config("city2"))
    assert walls.shape == (136, 2, 2)
    assert np.all(np.linalg.norm(walls[:, 1] - walls[:, 0], axis=-1) > 0)
