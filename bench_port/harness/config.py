"""What a configuration file states: the scene's walls, the footprints
transmitters stay out of, the receiver grid and the request's options."""

from __future__ import annotations

import numpy as np


def walls(config: dict) -> np.ndarray:
    """``float32[W, 2, 2]``: the listed walls, or one wall per edge of each
    building's outer ring (the first edge closes the ring)."""
    scene = config["scene"]
    if "walls" in scene:
        return np.asarray(scene["walls"], dtype=np.float32).reshape(-1, 2, 2)
    edges = [[ring[i - 1], ring[i]] for ring in scene["buildings"] for i in range(len(ring))]
    return np.asarray(edges, dtype=np.float32).reshape(-1, 2, 2)


def footprints(config: dict) -> list:
    """The buildings' outer rings (``float64[n, 2]`` each); none for a scene
    of bare walls."""
    return [np.asarray(r, dtype=np.float64) for r in config["scene"].get("buildings", [])]


def grid_axes(config: dict, n=None) -> tuple:
    """``(xs, ys)``: the receiver grid's column and row coordinates
    (``n`` points each, by default the configuration's)."""
    g = config["grid"]
    n = g["n"] if n is None else n
    return np.linspace(*g["x"], n), np.linspace(*g["y"], n)


def request(config: dict) -> dict:
    """The request's options: orders, activation and scalars."""
    return dict(config["request"])
