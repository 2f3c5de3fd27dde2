"""The frozen operation and byte counts against hand counts."""

from __future__ import annotations

from roofline import counts


def test_ops_count_by_hand_on_two_walls():
    # Line of sight: one segment (8), validity and power (7), 2 blocked tests.
    los = 8 + 7 + 18 * 2
    # One bounce: two segments (16), one joint (1), validity and power (7),
    # bounce 12, a wall's loss 25, on-wall 9, gate 2; 2 tests (each segment
    # skips its wall).
    bounce = 16 + 1 + 7 + 12 + 25 + 9 + 2 + 18 * 2
    per_map = 22 * 2 + 12 * 2
    cands = {0: [[]], 1: [[0], [1]]}
    assert counts.map_ops(cands, (0, 0), 10, False) == 10 * (los + 2 * bounce) + per_map
    grad_los = los + 18 + 15
    grad_bounce = bounce + 12 + 2 + 18 + 7 + 15
    assert counts.map_ops(cands, (0, 0), 10, True) == 10 * (grad_los + 2 * grad_bounce) + per_map


def test_bytes_by_hand():
    cands = {0: [[]], 1: [[0], [1]]}
    inputs = 8 * 10 + 24 * 2 + 8 + 4 * 2
    assert counts.map_bytes(cands, 2, 10, False) == inputs + 4 * 10
    assert counts.map_bytes(cands, 2, 10, True) == inputs + 12 * 10


def test_basic_scene_counts():
    cands = {0: [[]], 1: [[i] for i in range(7)]}
    P = 1024 * 1024
    value = counts.map_ops(cands, (0,) * 7, P, False)
    grad = counts.map_ops(cands, (0,) * 7, P, True)
    assert (value - counts.map_ops(cands, (0,) * 7, 0, False)) == 2157 * P
    assert (grad - counts.map_ops(cands, (0,) * 7, 0, True)) == 2568 * P
    least, by = counts.least_seconds(value, counts.map_bytes(cands, 7, P, False))
    assert by == "operations" and abs(least - 3.3758e-5) < 1e-8
