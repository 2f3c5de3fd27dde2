"""The port's candidate enumeration and graph API against :mod:`differt2d_tpu.rt`.

The cases of ``tests/test_rt.py`` (counts, no consecutive repeats,
lexicographic order, ``filter_nodes``, the matrices per order, the flat list
form and the graph stand-ins of ``differt_core.rt``), each output
``np.array_equal`` to the JAX package's; ``available()`` of the native
enumerator; and the three geometry functions the port exports checked
(``segments_intersect``, ``path_length``, ``normalize``) against
``differt2d_tpu.geometry`` at ``tests/test_torch_geometry.py``'s tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt2d_tpu.logic as jlogic
from differt2d_tpu import geometry as jgeometry
from differt2d_tpu import rt as jrt

import differt2d_tpu_torch.logic as tlogic
from differt2d_tpu_torch import geometry, rt
from differt2d_tpu_torch.rt import _native

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _equal_rows(port, ref) -> None:
    port, ref = list(port), list(ref)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else p
        assert p.dtype == np.int32
        assert np.array_equal(p, np.asarray(r)), (p, r)


@pytest.mark.parametrize("n", [1, 2, 4, 7])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_counts(n, order):
    mat = rt.candidates_for_order(n, order)
    expected = 1 if order == 0 else n if order == 1 else n * (n - 1) ** (order - 1)
    assert mat.shape == (expected, order)
    assert np.array_equal(mat, jrt.candidates_for_order(n, order))


def test_no_consecutive_repeats():
    mat = rt.candidates_for_order(5, 3)
    assert not np.any(mat[:, 1:] == mat[:, :-1])
    assert np.array_equal(mat, jrt.candidates_for_order(5, 3))


def test_lexicographic_order():
    mat = rt.candidates_for_order(5, 3).astype(np.int64)
    codes = mat @ (5 ** np.arange(2, -1, -1))
    assert np.all(np.diff(codes) > 0)


def test_filter_nodes():
    mat = rt.candidates_for_order(6, 2, filter_nodes=(1, 4))
    assert mat.shape == (4 * 3, 2)
    assert set(mat.flatten().tolist()) <= {0, 2, 3, 5}
    assert np.array_equal(mat, jrt.candidates_for_order(6, 2, filter_nodes=(1, 4)))


def test_path_candidate_matrices_orders():
    groups = rt.path_candidate_matrices(7, 0, 2)
    ref = jrt.path_candidate_matrices(7, 0, 2)
    assert sorted(groups) == sorted(ref) == [0, 1, 2]
    assert [groups[o].shape for o in (0, 1, 2)] == [(1, 0), (7, 1), (42, 2)]
    for o in ref:
        assert np.array_equal(groups[o], ref[o])


@pytest.mark.parametrize("kw", [dict(min_order=0, max_order=2), dict(order=3),
                                dict(min_order=1, max_order=2, filter_nodes=[4, 0]),
                                dict(min_order=2, max_order=2)])
def test_all_path_candidates_list_form(kw):
    lst = rt.all_path_candidates(5, **kw)
    assert all(c.device.type == "cpu" for c in lst)
    _equal_rows(lst, jrt.all_path_candidates(5, **kw))
    if kw == dict(min_order=0, max_order=2):
        assert len(lst) == 1 + 5 + 20
        assert lst[0].shape == (0,) and lst[1].shape == (1,) and lst[-1].shape == (2,)
        assert [int(a[0]) for a in lst[1:6]] == [0, 1, 2, 3, 4]


def test_graph_shims():
    for include in (False, True):
        for depth in (2, 3, 4):
            _equal_rows(rt.CompleteGraph(4).all_paths(4, 5, depth, include_from_and_to=include),
                        jrt.CompleteGraph(4).all_paths(4, 5, depth, include_from_and_to=include))
    g = rt.CompleteGraph(4)
    assert len(list(g.all_paths(4, 5, 3))) == 4
    assert next(g.all_paths(4, 5, 3, include_from_and_to=True)).tolist() == [4, 0, 5]

    dg, jdg = rt.DiGraph.from_complete_graph(g), jrt.DiGraph.from_complete_graph(jrt.CompleteGraph(4))
    assert dg.insert_from_and_to_nodes() == jdg.insert_from_and_to_nodes() == (4, 5)
    dg.disconnect_nodes(0, 2)
    jdg.disconnect_nodes(0, 2)
    assert [p.tolist() for p in dg.all_paths(4, 5, 4)] == [[1, 3], [3, 1]]
    for include in (False, True):
        _equal_rows(dg.all_paths(4, 5, 4, include_from_and_to=include),
                    jdg.all_paths(4, 5, 4, include_from_and_to=include))


def test_graph_serves_large_sets_from_the_native_enumerator(monkeypatch):
    """At 1,024 rows and more the graph's paths come from the native
    enumerator (the city extract's 136 walls at order 2: 18,360 rows)."""
    calls = []
    real = _native.enumerate_paths
    monkeypatch.setattr(_native, "enumerate_paths", lambda *a: calls.append(a) or real(*a))
    rt.candidates_for_order.cache_clear()
    paths = list(rt.DiGraph(136).all_paths(136, 137, 4))
    assert calls and len(paths) == 136 * 135
    _equal_rows(paths[:500:7], list(jrt.DiGraph(136).all_paths(136, 137, 4))[:500:7])


def test_native_available():
    assert rt.available() is True
    assert _native.available() is True


def test_geometry_exports_match():
    rng = np.random.default_rng(0)
    poly = rng.uniform(-1.0, 1.0, (10, 5, 2)).astype(np.float32)
    poly[0, 1] = poly[0, 0]  # a zero-length segment
    np.testing.assert_allclose(geometry.path_length(torch.from_numpy(poly)).numpy(),
                               np.asarray(jgeometry.path_length(jnp.asarray(poly))), **TOL)
    v = rng.uniform(-1.0, 1.0, (40, 2)).astype(np.float32)
    v[:3] = 0.0  # zero vectors
    for t, j in zip(geometry.normalize(torch.from_numpy(v)), jgeometry.normalize(jnp.asarray(v))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    p1, p2, p3, p4 = (rng.uniform(-1.0, 1.0, (200, 2)).astype(np.float32) for _ in range(4))
    p4[:5] = p3[:5] + (p2[:5] - p1[:5]) * 0.5  # parallel pairs
    for approx in (False, True):
        kw = dict(alpha=20.0, function=tlogic.sigmoid) if approx else {}
        jkw = dict(alpha=20.0, function=jlogic.sigmoid) if approx else {}
        t = geometry.segments_intersect(*(torch.from_numpy(a) for a in (p1, p2, p3, p4)),
                                        approx=approx, **kw)
        j = jgeometry.segments_intersect(*(jnp.asarray(a) for a in (p1, p2, p3, p4)),
                                         approx=approx, **jkw)
        np.testing.assert_allclose(t.numpy().astype(np.float32), np.asarray(j, np.float32),
                                   **TOL)
