"""The system under test: ``differt2d_tpu_torch.tracer.power_map``.

The benchmark hands the program the configuration's walls, receiver grid
and options, and one transmitter row per request; it takes back the maps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as cfg


class Program:
    """One configuration's request, served one transmitter at a time."""

    def __init__(self, config: dict, device: torch.device, *, value_and_grad: bool,
                 grid_n=None):
        from differt2d_tpu_torch import Scene, logic
        from differt2d_tpu_torch.tracer import power_map

        self._power_map = power_map
        self.device = device
        self.scene = Scene.from_arrays(cfg.walls(config), device=device)
        xs, ys = cfg.grid_axes(config, grid_n)
        self.X, self.Y = torch.meshgrid(
            torch.tensor(xs, dtype=torch.float32, device=device),
            torch.tensor(ys, dtype=torch.float32, device=device), indexing="xy")
        self.pixels = self.X.numel()
        req = cfg.request(config)
        self.kw = dict(min_order=req["min_order"], max_order=req["max_order"],
                       approx=req["approx"], alpha=req["alpha"], tol=req["tol"],
                       patch=req["patch"], r_coef=req["r_coef"], height=req["height"],
                       function=getattr(logic, req["activation"]))
        self.value_and_grad = value_and_grad

    def __call__(self, tx: torch.Tensor):
        """The map of the transmitter ``tx[2]`` (a row on the device):
        ``[rows, cols]``, or ``([rows, cols], [rows, cols, 2])``."""
        return self._power_map(self.scene.with_transmitters(tx=tx), self.X, self.Y,
                               value_and_grad=self.value_and_grad, device=self.device,
                               **self.kw)


def flat(out) -> tuple:
    """``(value[P], gradient[P, 2] or None)`` of a map."""
    if isinstance(out, tuple):
        return out[0].reshape(-1), out[1].reshape(-1, 2)
    return out.reshape(-1), None


def grid_pixels(config: dict, grid_n=None) -> tuple:
    """``(px[P], py[P])`` float32, row-major like the program's grid."""
    xs, ys = cfg.grid_axes(config, grid_n)
    X, Y = np.meshgrid(np.asarray(xs, np.float32), np.asarray(ys, np.float32), indexing="xy")
    return X.reshape(-1), Y.reshape(-1)
