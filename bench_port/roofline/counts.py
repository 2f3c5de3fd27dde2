"""Operations and bytes of one power map, and the card's published peaks.

The counts depend on the request alone (its candidates, walls, mode and
grid), never on what the program does to serve it, so they read the same
work whatever implements the map.  Operations are counted by hand: one per
float add, sub, mul, div, sqrt or exp; selects, compares and min/max are
free.  Each value is counted once, where it first depends on the pixel:
per-wall values and the transmitter's mirror images once per map, a
segment's vector once per segment, the blocked test in its folded form
(``z = num * (alpha / den)``, margins against constants of the map), and
the gradient of a max or min through the selected argument only.  Every
segment is tested against every wall but its own two.  Bytes count each
input once and the map once.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
"""NVIDIA H100 SXM, float32 outside the tensor cores (data sheet, at 700 W)."""
PEAK_HBM_BYTES_PER_S = 3.35e12
"""NVIDIA H100 SXM, HBM3 (data sheet)."""

OPS_PER_WALL = 22    # direction 2, |d|^2 3, sqrt and normal 3, 1/|d|^2 1, a.n 3,
#                      patched ends 8, sin/cos 2
OPS_PER_IMAGE = 12   # per map and bounce: mirror 9, image.n 3
OPS_BOUNCE = 12      # backward image step: p.n 3, un 1, vn 1, vn/un 1, u 2, p + s u 4
OPS_SEGMENT = 8      # vector 2, length |v + eps| 6 (plus one add per extra segment)
OPS_LOSS = {0: 25, 1: 17}  # wall: two unit vectors 12, reflect 8, |e|^2 5;
#                            RIS: unit vector 6, sin/cos 6, |e|^2 5
OPS_ON = 9           # t = (p - a).d / |d|^2 6, two margins 3
OPS_GATE = 2         # loss gate margin
OPS_TEST = 18        # blocked test: a - c 2, num_a, num_b, den 9, alpha/den 1,
#                      z_a, z_b 2, four margins 4
OPS_VALID_POWER = 7  # folded validity 2, r^2 + h^2 and division 3, valid * power 1, sum 1
# With the pixel gradient:
OPS_JACOBIAN = 12    # rank-1 bounce Jacobian: f 1, g 4, d - g n 4, scale 3
OPS_ON_GRAD = 2      # slope times the bounce's rank-1 gradient
OPS_LOSS_GRAD_RIS = 31  # 2e weights 8, rw 3, q 6, two contractions 10, sum 4
OPS_BLOCK_GRAD = 18  # selected wall's partials 14, times the slope 4
OPS_CONTRACT = 7     # per bounce end of that segment: k 3, two products 2, sum 2
OPS_POWER_GRAD = 15  # dP/dr 3, unit vector 2, products 2, value rule 6, sum 2

KIND_VERTEX = 2


def cand_ops(row, kinds: tuple, with_grad: bool) -> tuple[int, int, int]:
    """``(operations besides the blocked tests, blocked tests, operations
    per map)`` of one candidate (its wall indices ``row``)."""
    order = len(row)
    wall_kinds = [k for k in kinds if k != KIND_VERTEX]
    bounces = [kinds[i] for i in row if kinds[i] != KIND_VERTEX]
    ids = [-1, *row, -1]
    tested = sum(
        len(wall_kinds) - sum(1 for w in {ids[s], ids[s + 1]}
                              if w >= 0 and kinds[w] != KIND_VERTEX)
        for s in range(order + 1)
    )
    f = OPS_SEGMENT * (order + 1) + order + OPS_VALID_POWER
    f += sum(OPS_BOUNCE + OPS_LOSS[k] + OPS_ON for k in bounces)
    f += OPS_GATE if bounces else 0
    if with_grad:
        f += sum(OPS_JACOBIAN + OPS_ON_GRAD + (OPS_LOSS_GRAD_RIS if k == 1 else 0)
                 for k in bounces)
        f += OPS_BLOCK_GRAD + (OPS_CONTRACT if bounces else 0) + OPS_POWER_GRAD
    return f, tested, OPS_PER_IMAGE * len(bounces)


def map_ops(cands: dict, kinds: tuple, pixels: int, with_grad: bool) -> int:
    """Operations of one map of one transmitter over ``pixels`` receivers,
    ``cands`` the request's candidates (``{order: rows}``)."""
    per_pixel, per_map = 0, OPS_PER_WALL * len(kinds)
    for rows in cands.values():
        for row in rows:
            f, tested, img = cand_ops([int(i) for i in row], kinds, with_grad)
            per_pixel += f + OPS_TEST * tested
            per_map += img
    return per_pixel * pixels + per_map


def map_bytes(cands: dict, num_walls: int, pixels: int, with_grad: bool) -> int:
    """Bytes of one map: the pixels' coordinates, the walls (four floats),
    their kinds and phases, the transmitter and the candidates' wall indices
    (4 bytes each) read once, and the map (with the gradient: three floats a
    pixel) written once."""
    inputs = 8 * pixels + 24 * num_walls + 8 + 4 * sum(len(r) * len(r[0]) for r in cands.values()
                                                        if len(r) and len(r[0]))
    return inputs + (12 if with_grad else 4) * pixels


def least_seconds(ops: int, nbytes: int) -> tuple[float, str]:
    """The least time of the work on the card and what bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
