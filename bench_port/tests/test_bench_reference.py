"""The plain reference against hand-worked two-wall cases."""

from __future__ import annotations

import pytest
import torch

from reference import tracer as ref

OPTS = {"min_order": 0, "max_order": 1, "activation": "hard_sigmoid", "alpha": 100.0,
        "tol": 0.01, "patch": 0.0, "r_coef": 0.5, "height": 0.1}
GATE = 4.0 / 6.0  # f(tol) = relu6(100 * 0.01 + 3) / 6: the loss gate of an exact path
LOS = 1.0 / (0.01 + 0.25)   # |tx - rx| = 0.5
ONE = 0.5 / (0.01 + 1.25)   # one bounce at the midpoint: path length sqrt(1.25)


@pytest.mark.parametrize("walls, expected", [
    # Floor and ceiling: the line of sight and one bounce off each.
    ([[[0.0, 0.0], [1.0, 0.0]], [[0.0, 1.0], [1.0, 1.0]]], GATE * (LOS + 2 * ONE)),
    # Floor and a wall across the line of sight: the floor's bounce alone
    # (the blocker's own image path lands on the receiver and fails its loss).
    ([[[0.0, 0.0], [1.0, 0.0]], [[0.5, 0.25], [0.5, 0.75]]], GATE * ONE),
])
def test_two_walls_by_hand(walls, expected):
    w = torch.tensor(walls)
    z = ref.power_map(w, torch.tensor([0.25, 0.5]), torch.tensor([0.75]), torch.tensor([0.5]),
                      OPTS)
    assert z.shape == (1,)
    assert float(z[0]) == pytest.approx(expected, rel=1e-5)


def test_candidates_skip_repeats():
    c = ref.candidates(3, 0, 2)
    assert c[0].shape == (1, 0) and c[1].tolist() == [[0], [1], [2]]
    assert c[2].tolist() == [[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]]


def test_gradient_is_the_derivative_of_the_map():
    w = torch.tensor([[[0.0, 0.0], [1.0, 0.0]], [[0.0, 1.0], [1.0, 1.0]]], dtype=torch.float64)
    tx = torch.tensor([0.25, 0.5], dtype=torch.float64)
    x, y = torch.tensor([0.7], dtype=torch.float64), torch.tensor([0.45], dtype=torch.float64)
    _, g = ref.power_map_and_grad(w, tx, x, y, OPTS)
    h = 1e-6
    dx = (ref.power_map(w, tx, x + h, y, OPTS) - ref.power_map(w, tx, x - h, y, OPTS)) / (2 * h)
    dy = (ref.power_map(w, tx, x, y + h, OPTS) - ref.power_map(w, tx, x, y - h, OPTS)) / (2 * h)
    assert float(g[0, 0]) == pytest.approx(float(dx[0]), rel=1e-5)
    assert float(g[0, 1]) == pytest.approx(float(dy[0]), rel=1e-5)
