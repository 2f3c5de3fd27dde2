"""The port's geometry primitives against :mod:`differt2d_tpu.ops.geometry_ops`.

Inputs come from a NumPy seed (with degenerate rows mixed in: zero-length
walls, zero vectors, parallel segments); the same float32 arrays go to
both sides.  Values match at rtol 1e-5 / atol 1e-6 (float32, a few ops
of reassociation).  Reverse-mode gradients at the degenerate rows stay
finite: every guard is a double ``where``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt2d_tpu.logic as jlogic
from differt2d_tpu.ops import geometry_ops as jops
import differt2d_tpu_torch.logic as tlogic
from differt2d_tpu_torch.ops import geometry_ops as tops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _points(seed, shape):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (*shape, 2)).astype(np.float32)


def _walls(seed, n):
    w = np.stack([_points(seed, (n,)), _points(seed + 100, (n,))], axis=-2)
    w[0, 1] = w[0, 0]  # zero-length wall (a vertex)
    w[1] = [[0.0, 0.0], [1.0, 0.0]]
    return w


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _both(fn_name, *arrays):
    t = getattr(tops, fn_name)(*(torch.from_numpy(a) for a in arrays))
    j = getattr(jops, fn_name)(*(jnp.asarray(a) for a in arrays))
    return t, j


@pytest.mark.parametrize(
    "name", ["wall_normal", "parametric_to_cartesian", "cartesian_to_parametric",
             "mirror_point", "specular_residual", "ris_residual"]
)
def test_wall_functions_match(name):
    W = 32
    walls = _walls(0, W)
    pts = _points(1, (W,))
    pts2 = _points(2, (W,))
    t = np.random.default_rng(3).uniform(-0.5, 1.5, W).astype(np.float32)
    phi = np.random.default_rng(4).uniform(-3.0, 3.0, W).astype(np.float32)
    args = {
        "wall_normal": (walls,),
        "parametric_to_cartesian": (walls, t),
        "cartesian_to_parametric": (walls, pts),
        "mirror_point": (pts, walls),
        "specular_residual": (pts, pts2, _points(5, (W,)), walls),
        "ris_residual": (pts, pts2, walls, phi),
    }[name]
    _close(*_both(name, *args))


def test_normalize_and_path_length_match():
    v = _points(6, (40,))
    v[:3] = 0.0  # zero vectors
    (tu, tl), (ju, jl) = _both("normalize", v)
    _close(tu, ju)
    _close(tl, jl)
    poly = _points(7, (10, 5))
    poly[0, 1] = poly[0, 0]  # a zero-length segment
    _close(*_both("path_length", poly))


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("name", ["hard_sigmoid", "sigmoid"])
def test_segments_intersect_matches(approx, name):
    n = 200
    p1, p2, p3, p4 = (_points(10 + k, (n,)) for k in range(4))
    p4[:5] = p3[:5] + (p2[:5] - p1[:5]) * 0.5  # parallel pairs: den == 0
    kw = dict(alpha=20.0, function=getattr(tlogic, name)) if approx else {}
    jkw = dict(alpha=20.0, function=getattr(jlogic, name)) if approx else {}
    t = tops.segments_intersect(*(torch.from_numpy(a) for a in (p1, p2, p3, p4)),
                                approx=approx, **kw)
    j = jops.segments_intersect(*(jnp.asarray(a) for a in (p1, p2, p3, p4)),
                                approx=approx, **jkw)
    _close(t, j)


def test_degenerate_gradients_are_finite():
    """Zero vectors, zero-length walls and parallel segments: reverse mode
    through every primitive stays finite, alpha included."""
    walls = torch.from_numpy(_walls(20, 8)).requires_grad_(True)
    pts = torch.zeros(8, 2, requires_grad=True)
    alpha = torch.tensor(50.0, requires_grad=True)
    total = (
        tops.normalize(pts)[0].sum()
        + tops.path_length(torch.stack([pts, pts], dim=-2)).sum()
        + tops.wall_normal(walls).sum()
        + tops.mirror_point(pts, walls).sum()
        + tops.cartesian_to_parametric(walls, pts).sum()
        + tops.specular_residual(pts, pts, pts, walls).sum()
        + tops.ris_residual(pts, pts, walls, torch.zeros(8)).sum()
    )
    a = torch.tensor([[0.0, 0.0]], requires_grad=True)
    hit = tops.segments_intersect(
        a, a + torch.tensor([[1.0, 0.0]]), a + torch.tensor([[0.0, 0.5]]),
        a + torch.tensor([[1.0, 0.5]]), approx=True, alpha=alpha,
    )
    (total + hit.sum()).backward()
    for t in (walls, pts, alpha, a):
        assert torch.isfinite(t.grad).all()
