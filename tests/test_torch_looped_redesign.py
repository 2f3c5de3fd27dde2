"""The host-side pieces of the redesigned looped kernels, on the CPU.

* The rejection bounds are sound: every blocked test that
  ``power_map_looped.rejects`` skips has a margin, formed in float32 in
  ``seg_margin``'s order of operations, at or below the floor where the
  map cannot see it (hard logic: a miss; ``hard_sigmoid``: 0; sigmoid:
  -18 for the value map, -89 with the gradient).  Seeded random
  segment/wall pairs and pairs built a few ulps either side of each bound,
  at ``alpha`` 1, 100 and 1e4, in the three logic modes, with and without
  the gradient.
* The tiles' work list is a permutation of the tiles, longest first, and
  its counts equal a count made candidate by candidate.
* The sequential twins (the looped kernels', ``opt_solver_value_seq`` and
  ``power_map_vag_seq``) stay out of the dispatch: ``tracer.py`` and the
  wrappers it calls never name them.
* The CUDA sources' constants and exports match the wrappers'.
* Scenes with walls too short for the culling boxes keep culled ==
  identity tables.
"""

import inspect
import os
import re
import types

import numpy as np
import pytest
import torch

from differt2d_tpu_torch import Scene
from differt2d_tpu_torch import tracer
from differt2d_tpu_torch.ops import cull_tables
from differt2d_tpu_torch.ops import opt_solver_kernel as osk
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.ops import power_map_looped as pml
from differt2d_tpu_torch.ops.power_map_kernel import SOFT_HARD, SOFT_NONE, SOFT_SIGMOID

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "differt2d_tpu_torch", "ops", "csrc")
f32 = np.float32


def _terms(c, d, pa, pb):
    """``(num_a, num_b, den)`` of segment ``c -> d`` against the wall
    ``pa -> pb``, float32, in ``seg_margin``'s order."""
    av = pb - pa
    bv = c - d
    cv = pa - c
    num_a = bv[:, 1] * cv[:, 0] - bv[:, 0] * cv[:, 1]
    num_b = av[:, 0] * cv[:, 1] - av[:, 1] * cv[:, 0]
    den = av[:, 1] * bv[:, 0] - av[:, 0] * bv[:, 1]
    return num_a, num_b, den


def _margin(num_a, num_b, den, alpha, mode):
    """``seg_margin``'s result in float32: the hit (1 / -1) for hard logic,
    the pre-activation margin otherwise."""
    tol = torch.tensor(0.005, dtype=torch.float32)
    one = torch.tensor(1.005, dtype=torch.float32)
    a = torch.tensor(alpha, dtype=torch.float32)
    zero = den == 0
    safe = torch.where(zero, torch.ones_like(den), den)
    t_a, t_b = num_a / safe, num_b / safe
    if mode == SOFT_NONE:
        hit = (t_a >= -tol) & (t_a <= one) & (t_b >= -tol) & (t_b <= one) & ~zero
        return torch.where(hit, 1.0, -1.0)

    def zm(x):
        z = a * x
        return z + 3.0 if mode == SOFT_HARD else z

    m = torch.minimum(torch.minimum(zm(t_a + tol), zm(one - t_a)),
                      torch.minimum(zm(t_b + tol), zm(one - t_b)))
    return torch.where(zero, torch.full_like(m, -float("inf")), m)


def _floor(mode, grad):
    if mode == SOFT_NONE:
        return -1.0
    if mode == SOFT_HARD:
        return 0.0
    return pml.SIGMOID_VAG_FLOOR if grad else pml.SIGMOID_VALUE_FLOOR


def _random_pairs(rng, n):
    pts = rng.uniform(-0.2, 1.2, size=(4, n, 2)).astype(f32)
    return _terms(*(torch.from_numpy(p) for p in pts))


def _pairs_at_bounds(rng, bounds, n_per=400):
    """Numerators and denominators whose quotients lie within a few ulps of
    each bound, on either side, with denominators from 1e-6 to 1e3 of
    either sign (and near the least the rejection takes)."""
    nums_a, nums_b, dens = [], [], []
    for t in bounds:
        if not np.isfinite(t):
            continue
        t32 = f32(t)
        near = [t32]
        lo = hi = t32
        for _ in range(6):
            lo = np.nextafter(lo, f32(-np.inf))
            hi = np.nextafter(hi, f32(np.inf))
            near += [lo, hi]
        mag = np.concatenate([10.0 ** rng.uniform(-6, 3, n_per), [2.0 ** -90, 2.0 ** -89]])
        den = (mag * rng.choice([-1.0, 1.0], mag.size)).astype(f32)
        for tn in near:
            num = (den.astype(np.float64) * float(tn)).astype(f32)
            other = (den.astype(np.float64) * rng.uniform(0.2, 0.8, den.size)).astype(f32)
            nums_a += [num, other]
            nums_b += [other, num]
            dens += [den, den]
    cat = lambda xs: torch.from_numpy(np.concatenate(xs))  # noqa: E731
    return cat(nums_a), cat(nums_b), cat(dens)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("mode", [SOFT_NONE, SOFT_HARD, SOFT_SIGMOID])
@pytest.mark.parametrize("alpha", [1.0, 100.0, 1e4])
def test_rejected_tests_are_at_or_below_the_floor(alpha, mode, grad):
    tlo, thi, sat = pml.rejection_bounds(alpha, mode, grad)
    assert np.isfinite(tlo) and np.isfinite(thi) and tlo < 0.0 < 1.0 < thi
    rng = np.random.default_rng(1000 * int(alpha) + 10 * mode + grad)
    floor = _floor(mode, grad)
    # The unwidened bounds: where the margin itself crosses the floor.
    edges = [tlo / (1.0 + pml._REJECT_SLACK), thi / (1.0 + pml._REJECT_SLACK)]
    for num_a, num_b, den in (_random_pairs(rng, 20000),
                              _pairs_at_bounds(rng, [tlo, thi, *edges])):
        rej = pml.rejects(num_a, num_b, den, tlo, thi)
        m = _margin(num_a, num_b, den, alpha, mode)
        assert bool((m[rej] <= floor).all()), (
            f"{int((m[rej] > floor).sum())} rejected tests above the floor {floor}")
        assert not bool(m[rej].isnan().any())
        assert 0 < int(rej.sum()) < rej.numel()
    if mode == SOFT_HARD and alpha == 100.0:
        # Most clear misses of a random city segment go without a division.
        num_a, num_b, den = _random_pairs(rng, 20000)
        assert float(pml.rejects(num_a, num_b, den, tlo, thi).float().mean()) > 0.5


def test_rejection_is_off_where_it_cannot_be_proven():
    inf = float("inf")
    assert pml.rejection_bounds(0.0, SOFT_HARD, False) == (-inf, inf, inf)
    assert pml.rejection_bounds(100.0, SOFT_SIGMOID, True, sigmoid_bands_ok=False) == (
        -inf, inf, inf)
    num = torch.tensor([-5.0, 5.0, 0.5])
    den = torch.ones(3)
    assert not bool(pml.rejects(num, num, den, -inf, inf).any())
    # Non-finite or tiny denominators and non-finite numerators reject nothing.
    tlo, thi, _ = pml.rejection_bounds(100.0, SOFT_HARD, False)
    bad = torch.tensor([float("nan"), inf, 2.0 ** -100, 1.0])
    num_a = torch.tensor([-5.0, -5.0, -5.0, float("nan")])
    assert not bool(pml.rejects(num_a, torch.zeros(4), bad, tlo, thi).any())


def _plan(scene, n, max_order, tile):
    x = torch.linspace(0.02, 0.98, n)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    o = {**tracer._OPTIONS, "max_order": max_order, "approx": True}
    inputs = pml.looped_inputs(tracer._groups_for(scene, o), "cpu", approx=True,
                               sigmoid=False)
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = tuple(o[k] for k in tracer._SCALAR_NAMES)
    plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs, approx=True,
                         sigmoid=False, tile=tile)
    return plan, inputs


def _brute_tests(plan, inputs, kind, t):
    """Blocked tests of tile ``t``, candidate by candidate."""
    tb = plan.per_tx[0].tables
    W = kind.shape[0]
    solid = (kind != 2).tolist()
    unpack = cull_tables.unpack_words
    l0, last = unpack(tb.l0w, W), unpack(tb.lastw, W)[t]
    mid = unpack(tb.midw, W).reshape(W, W, W) if tb.midw.numel() else None

    def count(mask, skip):
        return sum(1 for w in range(W) if bool(mask[w]) and solid[w] and w not in skip)

    total = count(unpack(tb.losw, W)[t], ()) if inputs.has_los else 0
    for (o, cand), prm, cnt in zip(inputs.cands, tb.prm, tb.cnt):
        for c in prm[t, :int(cnt[t])].tolist():
            w = cand[c].tolist()
            total += count(l0[w[0]], (w[0],))
            total += sum(count(mid[w[s - 1], w[s]], (w[s - 1], w[s])) for s in range(1, o))
            total += count(last[w[-1]], (w[-1],))
    return total


@pytest.mark.parametrize("name,max_order", [("city", 1), ("basic", 3)])
def test_tile_work_list_is_longest_first(name, max_order):
    scene = (Scene.city_extract_scene(device="cpu") if name == "city"
             else Scene.basic_scene(device="cpu"))
    plan, inputs = _plan(scene, 40, max_order, (8, 8))
    tb = plan.per_tx[0].tables
    T = plan.tiles[0] * plan.tiles[1]
    tests = pml.tile_tests(tb, inputs, scene.kind)
    order = tb.order.long()
    assert tb.order.dtype == torch.int32 and tuple(tb.order.shape) == (T,)
    assert torch.equal(torch.sort(order).values, torch.arange(T))
    ranked = tests[order]
    assert bool((ranked[:-1] >= ranked[1:]).all())
    ties = ranked[:-1] == ranked[1:]
    assert bool((order[:-1][ties] < order[1:][ties]).all())
    assert int(tests.max()) > int(tests.min())
    for t in (int(order[0]), int(order[-1]), T // 2):
        assert int(tests[t]) == _brute_tests(plan, inputs, scene.kind, t)


_TWINS = {  # the wrapper module, its dispatching callables, the kernels' names
    "looped": (pml, ("value", "value_and_grad", "power_map_looped", "LoopedMapFunction",
                     "_launch"),
               {"power_map_looped_value", "power_map_looped_vag"},
               {"power_map_looped_value_seq", "power_map_looped_vag_seq"}),
    "solver": (osk, ("value", "full_value", "solver_map", "SolverMapFunction"),
               {"opt_solver_value"}, {"opt_solver_value_seq"}),
    "vag": (pmk, ("value", "value_and_grad", "power_map_kernel", "PowerMapFunction"),
            {"power_map_value", "power_map_vag"}, {"power_map_vag_seq"}),
}


@pytest.mark.parametrize("family", sorted(_TWINS))
def test_sequential_twins_stay_out_of_the_dispatch(family):
    """tracer.py and the wrappers it calls never name a sequential twin
    (power_map_looped_*_seq, opt_solver_value_seq, power_map_vag_seq)."""
    with open(inspect.getsourcefile(tracer)) as f:
        src = f.read()
    assert "_seq" not in src and "twin" not in src
    mod, callables, launches, twins = _TWINS[family]
    for name in callables:
        body = inspect.getsource(getattr(mod, name))
        assert "_seq" not in body and "twin_" not in body, name
    assert set(mod.LAUNCHES) == launches
    assert set(mod.TWIN_LAUNCHES) == twins


_SOURCES = {  # the CUDA source, its exports, the wrapper module
    "looped": ("power_map_looped.cu", ("power_map_looped_value", "power_map_looped_vag",
                                       "power_map_looped_value_seq", "power_map_looped_vag_seq",
                                       "sigmoid_band_probe"), pml),
    "solver": ("opt_solver.cu", ("opt_solver_value", "opt_solver_value_seq",
                                 "opt_solver_occupancy"), osk),
    "vag": ("power_map.cu", ("power_map_value", "power_map_vag", "power_map_vag_seq",
                             "power_map_occupancy", "power_map_sigmoid_band_probe"), pmk),
}


@pytest.mark.parametrize("family", sorted(_SOURCES))
def test_cuda_source_matches_the_wrapper(family):
    source, exports, mod = _SOURCES[family]
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    with open(os.path.join(CSRC, "power_map_common.cuh")) as f:
        common = f.read()
    assert re.search(r"kRejectMinDen = 0x1p-90f", common) and pml.REJECT_MIN_DEN == 2.0 ** -90
    assert re.search(r"kGateExit = 1;", common) and pmk.GATE_EXIT == 1
    for name in exports:
        assert re.search(rf"^int {name}\(", src, re.M), name
    # Every export the wrapper declares is in the source, with as many
    # parameters as the wrapper passes.
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in exports})
    mod._declare(lib)
    for name in exports:
        sig = re.search(rf"^int {name}\(([^{{]*)\)", src, re.M | re.S)
        params = sig.group(1)
        n = params.count(",") + 1 if "LP_ARGS" not in params else None
        if n is not None:
            assert len(getattr(lib, name).argtypes) == n, name


@pytest.mark.parametrize("max_order,mode", [(1, "hard_sigmoid"), (2, "hard_sigmoid"),
                                            (1, "sigmoid"), (1, "hard")])
def test_short_walls_culled_equal_identity(max_order, mode):
    """Walls of lengths 2^-100, 2^-115 and 2^-124 (blocked tests with |den|
    between 2^-126 and the rejection's 2^-90, and on-object tests that
    divide by 1 where |d|^2 underflows): the plain version with the culling
    tables equals it with identity tables, bit for bit (NaN where NaN)."""
    basic = Scene.basic_scene(device="cpu")
    short = np.array([[[0, 0], [2.0 ** -100, 2.0 ** -101]], [[0, 0], [2.0 ** -115, 2.0 ** -116]],
                      [[0, 0], [2.0 ** -124, 2.0 ** -125]], [[1, 1], [1, 1]]], np.float32)
    scene = Scene.from_arrays(np.concatenate([basic.walls.numpy(), short]),
                              transmitters={"tx": basic.transmitters["tx"].numpy()},
                              receivers={"rx": [0.5, 0.5]}, device="cpu")
    x = torch.linspace(0.01, 0.99, 12)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    approx, sig = mode != "hard", mode == "sigmoid"
    o = {**tracer._OPTIONS, "max_order": max_order, "approx": approx}
    groups = tracer._groups_for(scene, o)
    inputs = pml.looped_inputs(groups, "cpu", approx=approx, sigmoid=sig)
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = tuple(o[k] for k in tracer._SCALAR_NAMES)
    maps = []
    for on in (True, False):
        plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs, approx=approx,
                             sigmoid=sig, cull=on, shadow=on)
        maps.append(pml.plain_looped_value_and_grad(X.reshape(-1), Y.reshape(-1), scene.walls,
                                                    scene.kind, scene.phi, scal, inputs, plan))
    (v, g), (iv, ig) = maps
    assert torch.equal(v, iv)
    assert torch.equal(g.isnan(), ig.isnan()) and torch.equal(g.nan_to_num(), ig.nan_to_num())
    # The short walls are occluders of every segment, and the segments that
    # end on them list every wall.
    geo = cull_tables._shadow_geometry(scene.walls, scene.kind, txs[0], 0.0, 100.0, approx,
                                       sig, 1e-2)
    assert geo["short"].tolist() == [False] * 7 + [True, True, True, False]
    m0 = cull_tables.first_masks(geo, txs[0])
    assert bool(m0[:, 7:10].sum(0).eq(10).all()) and bool(m0[7:10, :10].sum(1).eq(9).all())
