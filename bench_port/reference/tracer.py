"""Plain image-method power map: the benchmark's reference.

A straightforward tracer in plain PyTorch, written from the model's
equations and independent of the program under test: it imports nothing of
the program and takes nothing the program made.  It enumerates every path
candidate of orders ``min_order..max_order`` itself (every sequence of
walls with no wall twice in a row), mirrors the transmitter through each
candidate's walls, intersects back from the receiver, and scores each path
with the soft logic:

* ``on``: every bounce lies on its wall, ``min_k min(f(t_k), f(1 - t_k))``;
* ``loss_ok``: ``f(tol - loss)``, ``loss`` the summed specular residual;
* ``blocked``: the largest soft intersection of any path segment with any
  wall other than the segment's two end walls (walls grown by ``patch``,
  parameters within ``[-0.005, 1.005]``; parallel lines never intersect);
* ``valid = min(on, 1 - blocked, loss_ok)`` (NaN read as 0), and the map
  sums ``valid * r_coef**order / (height**2 + length**2)``.

``f`` is the hard sigmoid ``relu6(alpha x + 3) / 6`` or the sigmoid
``1 / (1 + exp(-alpha x))``.  Where ``on`` or ``loss_ok`` is exactly 0,
``valid`` is 0 whatever the walls say, so the blocked test runs only on the
other (pixel, candidate) pairs: every candidate is scored, none is culled.

Every tensor takes the ``dtype`` it is given (float32 for the reference,
bfloat16 for the benchmark's control).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

INTERSECT_TOL = 0.005
"""Tolerance of the blocked test's line parameters."""
PAIRS = 1 << 26
TESTS = 1 << 25
"""Work per step: a city map's 65,536 checked pixels take about 1.1 s on an
H100 (a peak of 9.9 GB on the card), 1.4 s at a quarter of each."""


def candidates(num_walls: int, min_order: int, max_order: int) -> dict:
    """``{order: long[C, order]}``: every sequence of ``order`` walls with
    no wall twice in a row, for each order."""
    out = {}
    for o in range(min_order, max_order + 1):
        rows = [
            seq for seq in itertools.product(range(num_walls), repeat=o)
            if all(a != b for a, b in zip(seq, seq[1:]))
        ]
        out[o] = torch.tensor(rows, dtype=torch.long).reshape(len(rows), o)
    return out


def activation(name: str, alpha: float):
    if name == "hard_sigmoid":
        return lambda x: torch.nn.functional.relu6(alpha * x + 3.0) / 6.0
    if name == "sigmoid":
        return lambda x: torch.sigmoid(alpha * x)
    msg = f"unknown activation {name!r}"
    raise ValueError(msg)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` over the last axis (zero vectors stay zero)."""
    n2 = _dot(v, v)
    n = torch.sqrt(torch.where(n2 == 0, torch.ones_like(n2), n2))
    return v / n[..., None]


def normals(walls: torch.Tensor) -> torch.Tensor:
    """Unit normals ``[W, 2]``: each wall's direction turned by -90 degrees."""
    d = walls[:, 1] - walls[:, 0]
    return _unit(torch.stack([d[:, 1], -d[:, 0]], dim=-1))


def _images(tx: torch.Tensor, walls: torch.Tensor, nrm: torch.Tensor,
            cand: torch.Tensor) -> list:
    """The transmitter's mirror images through each candidate's walls:
    ``o`` tensors ``[C, 2]``."""
    image = tx.expand(cand.shape[0], 2)
    out = []
    for k in range(cand.shape[1]):
        n, a = nrm[cand[:, k]], walls[cand[:, k], 0]
        image = image - 2.0 * _dot(image - a, n)[:, None] * n
        out.append(image)
    return out


def _bounces(rx: torch.Tensor, images: list, walls: torch.Tensor, nrm: torch.Tensor,
             cand: torch.Tensor) -> list:
    """Bounce points ``[P, C, 2]`` of every pixel ``rx[P, 2]`` and candidate,
    last bounce first intersected back from the receiver."""
    P, C, o = rx.shape[0], cand.shape[0], cand.shape[1]
    point = rx[:, None, :].expand(P, C, 2)
    pts = [None] * o
    for k in range(o - 1, -1, -1):
        n, a = nrm[cand[:, k]], walls[cand[:, k], 0]
        u = point - images[k]
        un = _dot(u, n)
        vn = _dot(a - point, n)
        zero = un == 0
        step = torch.where(zero, torch.zeros_like(un), vn / torch.where(zero, torch.ones_like(un), un))
        point = point + step[..., None] * u
        pts[k] = point
    return pts


def _intersect(f, wa, wb, sa, sb) -> torch.Tensor:
    """Soft test of segment ``sa-sb`` against grown wall ``wa-wb``."""
    a = wb - wa
    b = sa - sb
    c = wa - sa
    num_a = b[..., 1] * c[..., 0] - b[..., 0] * c[..., 1]
    num_b = a[..., 0] * c[..., 1] - a[..., 1] * c[..., 0]
    den = a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]
    zero = den == 0
    safe = torch.where(zero, torch.ones_like(den), den)

    def inside(num):
        t = num / safe
        inner = torch.minimum(f(t + INTERSECT_TOL), f(1.0 + INTERSECT_TOL - t))
        return torch.where(zero, torch.zeros_like(inner), inner)

    return torch.minimum(inside(num_a), inside(num_b))


def _blocked(f, path: torch.Tensor, ids: torch.Tensor, walls: torch.Tensor, patch: float,
             block: int) -> torch.Tensor:
    """Largest soft hit of any segment of ``path[N, S + 1, 2]`` by a wall
    other than its two end walls (``ids[N, S + 1]``, -1 at the ends)."""
    N, S = path.shape[0], path.shape[1] - 1
    W = walls.shape[0]
    d = walls[:, 1] - walls[:, 0]
    wa = (walls[:, 0] - patch * d)[None, None]
    wb = (walls[:, 1] + patch * d)[None, None]
    wid = torch.arange(W, device=walls.device)[None, None]
    out = []
    for s in range(0, N, block):
        p, i = path[s:s + block], ids[s:s + block]
        sa, sb = p[:, :-1, None, :], p[:, 1:, None, :]
        hit = _intersect(f, wa, wb, sa, sb)
        own = (wid == i[:, :-1, None]) | (wid == i[:, 1:, None])
        hit = torch.where(own, torch.zeros_like(hit), hit)
        out.append(hit.reshape(hit.shape[0], S * W).amax(dim=-1))
    return torch.cat(out) if out else path.new_zeros(0)


def _group(f, tx, rx, walls, nrm, cand, opts: dict, block: int) -> torch.Tensor:
    """``[P]``: the group's summed ``valid * power`` at each pixel."""
    P, (C, o) = rx.shape[0], cand.shape
    pts = _bounces(rx, _images(tx, walls, nrm, cand), walls, nrm, cand) if o else []
    full = [tx.expand(P, C, 2), *pts, rx[:, None, :].expand(P, C, 2)]
    on = torch.ones(P, C, dtype=rx.dtype, device=rx.device)
    loss = torch.zeros(P, C, dtype=rx.dtype, device=rx.device)
    for k in range(o):
        a, d, n = walls[cand[:, k], 0], walls[cand[:, k], 1] - walls[cand[:, k], 0], nrm[cand[:, k]]
        sq = _dot(d, d)
        t = _dot(d, pts[k] - a) / torch.where(sq == 0, torch.ones_like(sq), sq)
        on = torch.minimum(on, torch.minimum(f(t), f(1.0 - t)))
        i = _unit(full[k + 1] - full[k])
        r = _unit(full[k + 2] - full[k + 1])
        e = r - (i - 2.0 * _dot(i, n)[..., None] * n)
        loss = loss + _dot(e, e)
    loss_ok = f(opts["tol"] - loss)  # also at order 0, where it is f(tol)
    path = torch.stack(full, dim=2)  # [P, C, o + 2, 2]
    seg = torch.diff(path, dim=2) + torch.finfo(torch.float32).eps
    length = torch.sqrt(_dot(seg, seg)).sum(dim=-1)
    power = opts["r_coef"] ** o / (opts["height"] ** 2 + length * length)
    valid = torch.minimum(on, loss_ok)
    live = (valid > 0).nonzero()  # NaN and 0 leave valid at 0
    if live.shape[0]:
        p, c = live[:, 0], live[:, 1]
        ends = torch.full((C, 1), -1, dtype=torch.long, device=rx.device)
        ids = torch.cat([ends, cand, ends], dim=1)[c]
        blk = _blocked(f, path[p, c], ids, walls, opts["patch"], block)
        keep = torch.nan_to_num(torch.minimum(valid[p, c], 1.0 - blk))
        valid = torch.zeros_like(valid).index_put((p, c), keep)
    else:
        valid = torch.zeros_like(valid)
    return (valid * power).sum(dim=-1)


def power_map(walls: torch.Tensor, tx: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
              opts: dict, *, cands: Optional[dict] = None) -> torch.Tensor:
    """Received power ``[P]`` at pixels ``(px, py)`` from one transmitter
    ``tx[2]``, in the dtype of ``px``.

    ``opts`` holds ``min_order``, ``max_order``, ``activation``, ``alpha``,
    ``tol``, ``patch``, ``r_coef`` and ``height``; ``cands`` the candidates
    (:func:`candidates` when not given).  Pixels run in chunks of about
    :data:`PAIRS` (pixel, candidate) pairs, the blocked test in blocks of
    about :data:`TESTS` (pair, segment, wall) tests.
    """
    dt, dev = px.dtype, px.device
    walls, tx = walls.to(device=dev, dtype=dt), tx.to(device=dev, dtype=dt)
    if cands is None:
        cands = candidates(walls.shape[0], opts["min_order"], opts["max_order"])
    cands = {o: c.to(dev) for o, c in cands.items()}
    f = activation(opts["activation"], opts["alpha"])
    nrm = normals(walls)
    chunk = max(1, PAIRS // max(1, sum(c.shape[0] for c in cands.values())))
    block = max(1, TESTS // max(1, (1 + max(cands)) * walls.shape[0]))
    rx = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    out = []
    for s in range(0, rx.shape[0], chunk):
        r = rx[s:s + chunk]
        z = torch.zeros(r.shape[0], dtype=dt, device=dev)
        for c in cands.values():
            if c.shape[0]:
                z = z + _group(f, tx, r, walls, nrm, c, opts, block)
        out.append(z)
    return torch.cat(out) if out else rx.new_zeros(0)


def power_map_and_grad(walls, tx, px, py, opts: dict, **kw) -> tuple:
    """``(value[P], gradient[P, 2])``: the map and its derivative with
    respect to each pixel's coordinates (autograd of the summed map, each
    pixel's value depending on that pixel alone)."""
    x = px.reshape(-1).detach().clone().requires_grad_(True)
    y = py.reshape(-1).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        z = power_map(walls, tx, x, y, opts, **kw)
        gx, gy = torch.autograd.grad(z.sum(), (x, y))
    return z.detach(), torch.stack([gx, gy], dim=-1)
