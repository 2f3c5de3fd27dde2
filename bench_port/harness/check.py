"""The comparison that decides ``correct``.

The maps the timed path produced for a sample of the window's requests
(drawn from the seed) are compared with the plain reference, computed for
the same transmitter and pixels: all pixels (``"pixels": null`` in
``checks/<cell>.json``), or a few drawn in every square block of the grid,
so that no culling tile goes unchecked.  Two numbers:

* ``map_err``: the largest ``|Z - R| / (|R| + VALUE_FLOOR)`` over the
  sampled pixels of every checked map (a pixel NaN on both sides agrees);
* ``grad_bad_share`` (gradient maps): the share of sampled pixels whose
  gradient is off by more than ``GRAD_TOL`` of ``max|dR| + GRAD_FLOOR``;
  a kink of the soft logic that rounding puts on the other side flips a
  pixel, so a few may differ where the map is right.

Each number is held to its limit in ``checks/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as cfg
from .system import flat, grid_pixels

VALUE_FLOOR = 1e-2
"""Power units: under a hundredth of the weakest order-2 path's power in
the unit square, so the error is relative wherever a path reaches."""
GRAD_FLOOR = 1.0
GRAD_TOL = 1e-2


def _err(got: np.ndarray, ref: np.ndarray, floor: float) -> np.ndarray:
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    with np.errstate(invalid="ignore"):
        e = np.abs(got - ref)
        if e.ndim > 1:
            e = e.max(axis=-1)
            scale = np.abs(ref).max(axis=-1)
        else:
            scale = np.abs(ref)
        e = e / (scale + floor)
    both = np.isnan(got).reshape(got.shape[0], -1).all(-1) & np.isnan(ref).reshape(
        ref.shape[0], -1).all(-1)
    e = np.where(both, 0.0, e)
    return np.where(np.isnan(e), np.inf, e)


def numbers(pairs: list, grad: bool) -> dict:
    """The compared numbers over ``[(program, reference), ...]``, each a
    ``(value[S], gradient[S, 2] or None)`` pair of NumPy arrays; a map the
    program never produced (None) fails every number."""
    if not pairs or any(p is None for p, _ in pairs):
        out = {"map_err": float("inf")}
        if grad:
            out["grad_bad_share"] = float("inf")
        return out
    out = {"map_err": float(max(_err(p[0], r[0], VALUE_FLOOR).max(initial=0.0)
                                for p, r in pairs))}
    if grad:
        bad = np.concatenate([_err(p[1], r[1], GRAD_FLOOR) > GRAD_TOL for p, r in pairs])
        out["grad_bad_share"] = float(bad.mean())
    return out


def pixel_sample(shape: tuple, rule, gen: np.random.Generator) -> np.ndarray:
    """Flat indices of the sampled pixels of one ``(rows, cols)`` map,
    sorted: all of them where ``rule`` is None, else ``rule["per_block"]``
    drawn without replacement in every ``rule["block"]``-square block of
    the grid, so that every block (a culling tile of the program or a
    union of them) has pixels checked."""
    rows, cols = shape
    if rule is None:
        return np.arange(rows * cols)
    b, k = int(rule["block"]), int(rule["per_block"])
    nby, nbx = -(-rows // b), -(-cols // b)
    blocks = np.arange(nby * nbx)[:, None]
    off = np.arange(b * b)[None, :]
    r = (blocks // nbx) * b + off // b
    c = (blocks % nbx) * b + off % b
    keys = gen.random(r.shape)
    keys[(r >= rows) | (c >= cols)] = 2.0  # past a ragged edge: drawn last
    k = min(k, b * b)
    pick = np.argpartition(keys, k - 1, axis=1)[:, :k]
    rr, cc = np.take_along_axis(r, pick, 1), np.take_along_axis(c, pick, 1)
    ok = (rr < rows) & (cc < cols)
    return np.sort((rr * cols + cc)[ok])


def program_side(out, idx: np.ndarray):
    """The program's map at the sampled pixels, on the host."""
    if out is None:
        return None
    value, gradient = flat(out)
    t = torch.as_tensor(idx)
    v = value.detach().cpu()[t].numpy()
    return v, None if gradient is None else gradient.detach().cpu()[t].numpy()


def reference_side(reference, config: dict, tx: torch.Tensor, idx: np.ndarray, *,
                   grad: bool, device: torch.device, dtype=torch.float32, grid_n=None):
    """The reference's map at the sampled pixels, in ``dtype``, on ``device``."""
    px, py = grid_pixels(config, grid_n)
    walls = torch.as_tensor(cfg.walls(config), device=device, dtype=dtype)
    x = torch.as_tensor(px[idx], device=device, dtype=dtype)
    y = torch.as_tensor(py[idx], device=device, dtype=dtype)
    t = tx.detach().to(device=device, dtype=dtype)
    opts = cfg.request(config)
    if grad:
        v, g = reference.power_map_and_grad(walls, t, x, y, opts)
        return v.float().cpu().numpy(), g.float().cpu().numpy()
    with torch.no_grad():
        return reference.power_map(walls, t, x, y, opts).float().cpu().numpy(), None
