"""The one traffic generator: every mix is a file of its parameters.

A run's draws come from ``--seed`` alone, each from a stream of its own
(transmitter rows, warm-up rows, which maps are checked and at which
pixels), so one seed gives one run's inputs.  Transmitters are drawn
stratified: the region is cut into ``strata x strata`` cells, every pass
visits each cell once in an order drawn from the seed and takes one
uniform point in it that is outside every building and ``wall_margin``
away from every wall.  So seeds share how their transmitters cover the
region and differ in their order and placement.
"""

from __future__ import annotations

import numpy as np

from . import config as cfg

TRIES = 32
"""Uniform points drawn at most in a cell per pass, one at a time until one
is admissible (a cell that yields none in a pass is skipped in that pass)."""

STREAMS = {"rows": 1, "warmup": 2, "maps": 4, "pixels": 5}
"""Each stream's number is fixed, so that a seed keeps the draws it was
measured with."""


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), STREAMS[stream]]))


def inside(points: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Even-odd test of ``points[..., 2]`` against one polygon ring."""
    x, y = points[..., 0][..., None], points[..., 1][..., None]
    ax, ay = ring[:, 0], ring[:, 1]
    bx, by = np.roll(ax, 1), np.roll(ay, 1)
    crosses = (ay > y) != (by > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = ax + (y - ay) * (bx - ax) / (by - ay)
    return (np.sum(crosses & (x < xs), axis=-1) % 2) == 1


def wall_distance(points: np.ndarray, walls: np.ndarray) -> np.ndarray:
    """Least distance of each of ``points[..., 2]`` to the walls."""
    a, b = walls[:, 0].astype(np.float64), walls[:, 1].astype(np.float64)
    d = b - a
    p = points[..., None, :]
    sq = np.maximum(np.sum(d * d, axis=-1), 1e-300)
    t = np.clip(np.sum((p - a) * d, axis=-1) / sq, 0.0, 1.0)
    q = a + t[..., None] * d
    return np.sqrt(np.min(np.sum((p - q) ** 2, axis=-1), axis=-1))


def admissible(config: dict, points: np.ndarray) -> np.ndarray:
    """Whether each point may hold a transmitter."""
    tx = config["transmitters"]
    ok = wall_distance(points, cfg.walls(config)) >= tx["wall_margin"]
    for ring in cfg.footprints(config) if tx["outside_footprints"] else ():
        ok &= ~inside(points, ring)
    return ok


def positions(config: dict, strata: int, count: int, gen: np.random.Generator) -> np.ndarray:
    """``float32[count, 2]`` transmitter positions, stratified passes."""
    x0, y0, x1, y1 = config["transmitters"]["region"]
    cells = strata * strata
    out, total = [], 0
    while total < count:
        order = gen.permutation(cells)
        corner = np.stack([x0 + (order % strata) * (x1 - x0) / strata,
                           y0 + (order // strata) * (y1 - y0) / strata], axis=-1)
        size = np.array([(x1 - x0) / strata, (y1 - y0) / strata])
        pick = np.full((cells, 2), np.nan)
        todo = np.arange(cells)
        for _ in range(TRIES):
            pts = corner[todo] + gen.random((todo.size, 2)) * size
            ok = admissible(config, pts)
            pick[todo[ok]] = pts[ok]
            todo = todo[~ok]
            if not todo.size:
                break
        pick = pick[~np.isnan(pick[:, 0])]
        if not pick.shape[0]:
            msg = "no admissible transmitter position in the region"
            raise ValueError(msg)
        out.append(pick)
        total += pick.shape[0]
    return np.concatenate(out)[:count].astype(np.float32)

