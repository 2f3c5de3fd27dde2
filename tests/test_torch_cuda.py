"""Kernel tests that need an NVIDIA GPU (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q -p no:randomly

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: values at rtol 1e-4 / atol 1e-5, gradients under the kink contract
at rtol 1e-3 / atol 1e-5.  The looped kernels' culled maps must also equal
their identity-table maps bit for bit, and the redesigned looped kernels
their sequential twins (``power_map_looped_value_seq`` / ``_vag_seq``).
"""

import pytest
import torch

from differt2d_tpu_torch import Scene
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.rt import path_candidate_matrices
from differt2d_tpu_torch.utils import kink_excess

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests cover the plain versions")
    return torch.device("cuda")


def _args(scene, n, max_order, approx, sigmoid, dev):
    X, Y = torch.meshgrid(
        torch.linspace(0.03, 0.97, n, device=dev),
        torch.linspace(0.02, 0.96, n, device=dev),
        indexing="xy",
    )
    groups = path_candidate_matrices(scene.num_objects, 0, max_order)
    inputs = pmk.kernel_inputs(groups, dev, approx=approx, sigmoid=sigmoid)
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = (100.0, 1e-2, 0.0, 0.5, 0.1)
    return (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), txs,
            scene.walls, scene.kind, scene.phi, scal, inputs)


@pytest.mark.parametrize("max_order", [0, 1, 2])
@pytest.mark.parametrize("mode", ["hard", "hard_sigmoid", "sigmoid"])
@pytest.mark.parametrize("name", ["basic", "mixed"])
def test_kernels_match_plain(cuda, name, mode, max_order):
    scene = Scene.basic_scene(device=cuda)
    if name == "mixed":
        scene = Scene.square_scene(device=cuda).add_ris([[0.5, 0.3], [0.5, 0.7]])
        scene = scene.add_vertex([0.25, 0.75])
    approx, sigmoid = mode != "hard", mode == "sigmoid"
    args = _args(scene, 64, max_order, approx, sigmoid, cuda)
    kw = dict(approx=approx, sigmoid=sigmoid)
    before = dict(pmk.LAUNCHES)
    got = pmk.value(*args, **kw)
    gv, gg = pmk.value_and_grad(*args, **kw)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES["power_map_value"] == before["power_map_value"] + 1
    assert pmk.LAUNCHES["power_map_vag"] == before["power_map_vag"] + 1
    ref = pmk.plain_value(*args)
    rv, rg = pmk.plain_value_and_grad(*args)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gv, rv, rtol=1e-4, atol=1e-5)
    n_bad, allowed = kink_excess(gg, rg, rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed


def test_wrappers_raise_instead_of_falling_back(cuda):
    scene = Scene.basic_scene(device=cuda)
    px, py, txs, walls, kind, phi, scal, inputs = _args(scene, 8, 1, True, False, cuda)
    kw = dict(approx=True, sigmoid=False)
    with pytest.raises(ValueError, match="float32"):
        pmk.value(px.double(), py.double(), txs, walls, kind, phi, scal, inputs, **kw)
    with pytest.raises(ValueError, match="expected"):
        pmk.value_and_grad(px, py, txs.cpu(), walls, kind, phi, scal, inputs, **kw)


# -- the looped kernels (city path) ---------------------------------------------------

from differt2d_tpu_torch.ops import power_map_looped as pml  # noqa: E402


def _looped(scene, n, approx, sigmoid, dev, cull=True, max_order=1):
    X, Y = torch.meshgrid(
        torch.linspace(0.02, 0.98, n, device=dev),
        torch.linspace(0.015, 0.985, n, device=dev),
        indexing="xy",
    )
    groups = path_candidate_matrices(scene.num_objects, 0, max_order)
    inputs = pml.looped_inputs(groups, dev, approx=approx, sigmoid=sigmoid)
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = (100.0, 1e-2, 0.0, 0.5, 0.1)
    plan = pml.make_plan(X, Y, txs, scene.walls, scene.kind, scal, inputs, approx=approx,
                         sigmoid=sigmoid, cull=cull, shadow=cull)
    return (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), scene.walls,
            scene.kind, scene.phi, scal, inputs, plan)


@pytest.mark.parametrize("mode", ["hard", "hard_sigmoid"])
@pytest.mark.parametrize("name", ["city_extract", "city_two_tx"])
def test_looped_kernels_match_plain_and_identity_tables(cuda, name, mode):
    scene = Scene.city_extract_scene(device=cuda)
    if name == "city_two_tx":
        scene = Scene.city_scene(device=cuda).update_transmitters(tx2=[0.5, 0.45])
    approx = mode != "hard"
    kw = dict(approx=approx, sigmoid=False)
    args = _looped(scene, 64, approx, False, cuda)
    ident = _looped(scene, 64, approx, False, cuda, cull=False)
    before = dict(pml.LAUNCHES)
    got = pml.value(*args, **kw)
    gv, gg = pml.value_and_grad(*args, **kw)
    iv = pml.value(*ident, **kw)
    ivv, ig = pml.value_and_grad(*ident, **kw)
    torch.cuda.synchronize()
    n_tx = len(args[-1].per_tx)
    assert pml.LAUNCHES["power_map_looped_value"] == before["power_map_looped_value"] + 2 * n_tx
    assert pml.LAUNCHES["power_map_looped_vag"] == before["power_map_looped_vag"] + 2 * n_tx
    assert torch.equal(got, iv) and torch.equal(gv, ivv) and torch.equal(gg, ig)
    ref = pml.plain_looped_value(*args)
    rv, rg = pml.plain_looped_value_and_grad(*args)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gv, rv, rtol=1e-4, atol=1e-5)
    n_bad, allowed = kink_excess(gg, rg, rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed


@pytest.mark.parametrize("mode", ["hard", "hard_sigmoid"])
@pytest.mark.parametrize("name,max_order", [("city_extract", 2), ("city_two_tx", 2),
                                            ("basic", 3)])
def test_looped_kernels_at_higher_orders(cuda, name, max_order, mode):
    """Orders >= 2 (middle segments, pair kills): culled == identity tables
    bit for bit, and the kernels against their plain versions."""
    scene = Scene.city_extract_scene(device=cuda)
    if name == "city_two_tx":
        scene = scene.update_transmitters(tx2=[0.5, 0.45])
    elif name == "basic":
        scene = Scene.basic_scene(device=cuda)
    approx = mode != "hard"
    kw = dict(approx=approx, sigmoid=False)
    args = _looped(scene, 24, approx, False, cuda, max_order=max_order)
    ident = _looped(scene, 24, approx, False, cuda, cull=False, max_order=max_order)
    assert args[6].max_order == max_order
    before = dict(pml.LAUNCHES)
    got = pml.value(*args, **kw)
    gv, gg = pml.value_and_grad(*args, **kw)
    iv = pml.value(*ident, **kw)
    ivv, ig = pml.value_and_grad(*ident, **kw)
    torch.cuda.synchronize()
    n_tx = len(args[-1].per_tx)
    assert pml.LAUNCHES["power_map_looped_value"] == before["power_map_looped_value"] + 2 * n_tx
    assert torch.equal(got, iv) and torch.equal(gv, ivv) and torch.equal(gg, ig)
    ref = pml.plain_looped_value(*args)
    rv, rg = pml.plain_looped_value_and_grad(*args)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gv, rv, rtol=1e-4, atol=1e-5)
    n_bad, allowed = kink_excess(gg, rg, rtol=1e-3, atol=1e-5)
    assert n_bad <= allowed
    assert float(got.sum()) > 0.0


def _random_city(seed, n_buildings, dev):
    """Rotated rectangular buildings (4 walls each) and a transmitter, from a
    NumPy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(n_buildings):
        cx, cy = rng.uniform(0.05, 0.95, 2)
        w, h = rng.uniform(0.01, 0.05, 2)
        c, s = np.cos(rng.uniform(0, np.pi)), np.sin(rng.uniform(0, np.pi))
        pts = [(cx + c * dx - s * dy, cy + s * dx + c * dy)
               for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h))]
        walls += [[pts[i - 1], pts[i]] for i in range(4)]
    tx = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    return Scene.from_arrays(np.asarray(walls, np.float32), transmitters={"tx": tx},
                             receivers={"rx": [0.5, 0.5]}, device=dev)


def _duplicated_wall(dev):
    """The basic scene with its third wall listed twice: in-range ties."""
    import numpy as np

    basic = Scene.basic_scene(device=dev)
    w = basic.walls.cpu().numpy()
    return Scene.from_arrays(np.concatenate([w, w[2:3]]),
                             transmitters={"tx": basic.transmitters["tx"].cpu().numpy()},
                             receivers={"rx": [0.5, 0.5]}, device=dev)


def _same(a, b):
    """torch.equal, NaN equal to NaN at the same elements."""
    return torch.equal(a, b) or (torch.equal(a.isnan(), b.isnan())
                                 and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _check_twins(scene, n, approx, sigmoid, dev, max_order):
    args = _looped(scene, n, approx, sigmoid, dev, max_order=max_order)
    kw = dict(approx=approx, sigmoid=sigmoid)
    before, twins = dict(pml.LAUNCHES), dict(pml.TWIN_LAUNCHES)
    v, tv = pml.value(*args, **kw), pml.twin_value(*args, **kw)
    (gv, gg), (tgv, tgg) = pml.value_and_grad(*args, **kw), pml.twin_value_and_grad(*args, **kw)
    torch.cuda.synchronize()
    n_tx = len(args[-1].per_tx)
    assert pml.LAUNCHES["power_map_looped_vag"] == before["power_map_looped_vag"] + n_tx
    assert (pml.TWIN_LAUNCHES["power_map_looped_vag_seq"]
            == twins["power_map_looped_vag_seq"] + n_tx)
    assert _same(v, tv) and _same(gv, tgv) and _same(gg, tgg)
    assert float(v.nan_to_num().abs().sum()) > 0.0


_TWIN_SCENES = [("city_scene", 1), ("city_scene", 2), ("random_city", 1), ("random_city", 2),
                ("random_city", 3), ("basic", 1), ("basic", 2), ("basic", 3)]


@pytest.mark.parametrize("mode", ["hard", "hard_sigmoid", "sigmoid", "ris_vertex"])
@pytest.mark.parametrize("name,max_order", _TWIN_SCENES)
def test_redesigned_looped_kernels_equal_their_sequential_twins(cuda, name, max_order, mode):
    """The redesigned sweep (rejection, winner-only partials, early exits,
    longest-first tiles) against the sequential one, bit for bit, on a
    20 x 20 grid (ragged 16 x 16 tiles)."""
    if name == "city_scene":
        scene = Scene.city_scene(device=cuda)
    elif name == "random_city":
        scene = _random_city(11, 10, cuda)
    else:
        scene = Scene.basic_scene(device=cuda)
    if mode == "ris_vertex":
        scene = scene.add_ris([[0.58, 0.35], [0.62, 0.35]]).add_vertex([0.45, 0.62])
    approx, sigmoid = mode != "hard", mode == "sigmoid"
    _check_twins(scene, 20, approx, sigmoid, cuda, max_order)


@pytest.mark.parametrize("mode", ["hard_sigmoid", "sigmoid"])
def test_redesigned_looped_kernels_on_in_range_ties(cuda, mode):
    """A duplicated wall gives two listed walls the same activation strictly
    inside (0, 1): the redesigned vag kernel reruns the sequential sweep
    there, and stays bit for bit."""
    _check_twins(_duplicated_wall(cuda), 48, True, mode == "sigmoid", cuda, 2)


def test_looped_sigmoid_bands_hold(cuda):
    pml._SIGMOID_BANDS.pop(str(cuda), None)
    assert pml.sigmoid_bands(cuda)


def test_looped_sigmoid_probe_saturates(cuda):
    pml._SIGMOID_SATURATES.pop(str(cuda), None)
    assert pml.sigmoid_saturates(cuda)


# -- the order-1 Fermat/MPT solver kernel ------------------------------------------------

from differt2d_tpu_torch import power_map, prng  # noqa: E402
from differt2d_tpu_torch import tracer as tr  # noqa: E402
from differt2d_tpu_torch.logic import sigmoid  # noqa: E402
from differt2d_tpu_torch.ops import opt_solver_kernel as osk  # noqa: E402

_SOLVER_CASES = {
    "ris_mpt": (True, dict(order=1, solver="mpt", steps=300, approx=True,
                           filter_objects=lambda o: o.kind == 1)),
    "fermat": (False, dict(order=1, solver="fermat", steps=100, approx=True)),
    "mpt": (False, dict(order=1, solver="mpt", steps=100, approx=True)),
    "mpt_hard": (False, dict(order=1, solver="mpt", steps=100, approx=False)),
    "fermat_los_sigmoid": (False, dict(min_order=0, max_order=1, solver="fermat", steps=100,
                                       approx=True, function=sigmoid)),
}


def _flip_stats(got, ref):
    err = (got - ref).abs()
    scale = 1.0 + ref.abs()
    flipped = err > 0.05 * scale
    rest = float((err[~flipped] / scale[~flipped]).max()) if bool((~flipped).any()) else 0.0
    return float(flipped.float().mean()), rest


@pytest.mark.parametrize("case", sorted(_SOLVER_CASES))
def test_solver_kernel_matches_plain(cuda, case):
    """Fermat at rtol 1e-3 / atol 1e-4, MPT under the flip contract."""
    with_ris, kw = _SOLVER_CASES[case]
    scene = Scene.square_scene(device=cuda).update_transmitters(tx2=[0.8, 0.3])
    if with_ris:
        scene = scene.add_ris([[0.5, 0.3], [0.5, 0.7]])
    o = {**tr._OPTIONS, **kw, "key": prng.PRNGKey(1234)}
    groups = tr._groups_for(scene, o)
    assert tr._route(scene, o, groups, "auto", grad=False) == "solver"
    X, Y = torch.meshgrid(torch.linspace(0.01, 0.99, 64, device=cuda),
                          torch.linspace(0.02, 0.98, 64, device=cuda), indexing="xy")
    args = osk.solver_request(scene, X, Y, groups, **tr._solver_options(o))
    before = osk.LAUNCHES["opt_solver_value"]
    got = osk.value(*args, approx=o["approx"], sigmoid=o["function"] is sigmoid)
    torch.cuda.synchronize()
    assert osk.LAUNCHES["opt_solver_value"] == before + 2  # one launch per transmitter
    ref = osk.plain_opt_value(*args)
    if o["solver"] == "fermat":
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
    else:
        rate, rest = _flip_stats(got, ref)
        assert rate <= 0.005 and rest <= 1e-3, (rate, rest)
    full = power_map(scene, X, Y, key=prng.PRNGKey(1234), **kw)
    eager_full = power_map(scene, X, Y, key=prng.PRNGKey(1234), backend="torch", **kw)
    torch.testing.assert_close(full, eager_full, rtol=1e-3, atol=1e-4)


def test_solver_autograd_through_the_kernel(cuda):
    scene = Scene.square_scene(device=cuda).add_ris([[0.5, 0.3], [0.5, 0.7]])
    X, Y = torch.meshgrid(torch.linspace(0.01, 0.99, 16, device=cuda),
                          torch.linspace(0.02, 0.98, 16, device=cuda), indexing="xy")
    kw = dict(order=1, solver="mpt", steps=100, approx=True, key=prng.PRNGKey(1234),
              filter_objects=lambda o: o.kind == 1)

    def grads(backend):
        phi = scene.phi.clone().requires_grad_(True)
        tx = scene.transmitters["tx"].clone().requires_grad_(True)
        sc = Scene.from_arrays(scene.walls, scene.kind, phi, {"tx": tx}, scene.receivers)
        out = power_map(sc, X, Y, backend=backend, **kw)
        return (out, *torch.autograd.grad(out.sum(), (phi, tx)))

    before = osk.LAUNCHES["opt_solver_value"]
    got = grads("auto")
    assert osk.LAUNCHES["opt_solver_value"] > before
    for g, r in zip(got, grads("torch")):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)


# -- the redesigned solver and gradient kernels against their twins -----------------------

import math  # noqa: E402

import numpy as np  # noqa: E402


def _short_walls(dev):
    """The basic scene with walls of lengths 2^-100, 2^-115 and 2^-124 at the
    origin (blocked tests with |den| between 2^-126 and 2^-90, below the
    rejection's least) and one of zero length at (1, 1)."""
    basic = Scene.basic_scene(device=dev)
    w = basic.walls.cpu().numpy()
    short = np.array([[[0, 0], [2.0 ** -100, 2.0 ** -101]], [[0, 0], [2.0 ** -115, 2.0 ** -116]],
                      [[0, 0], [2.0 ** -124, 2.0 ** -125]], [[1, 1], [1, 1]]], np.float32)
    return Scene.from_arrays(np.concatenate([w, short]),
                             transmitters={"tx": basic.transmitters["tx"].cpu().numpy()},
                             receivers={"rx": [0.5, 0.5]}, device=dev)


def _solver_scene(name, dev):
    square = Scene.square_scene(device=dev)
    if name.startswith("ris"):
        scene = square.add_ris([[0.5, 0.3], [0.5, 0.7]], phi=math.pi / 4)
        return scene.add_vertex([0.25, 0.75]) if name == "ris_vertex" else scene
    if name == "two_tx":
        return square.update_transmitters(tx2=[0.8, 0.3])
    if name == "zero_wall":
        w = square.walls.cpu().numpy()
        return Scene.from_arrays(
            np.concatenate([w, np.array([[[0.5, 0.5], [0.5, 0.5]]], np.float32)]),
            transmitters={"tx": square.transmitters["tx"].cpu().numpy()},
            receivers={"rx": [0.5, 0.5]}, device=dev)
    return square


_SOLVER_TWIN_CASES = {  # scene, options, candidates (None: the request's)
    "ris_mpt": ("ris", dict(order=1, solver="mpt", steps=1000,
                            filter_objects=lambda o: o.kind == 1), None),
    "fermat": ("square", dict(order=1, solver="fermat", steps=100), None),
    "mpt": ("square", dict(order=1, solver="mpt", steps=100), None),
    "fermat_los": ("square", dict(min_order=0, max_order=1, solver="fermat", steps=100), None),
    "mpt_hard": ("square", dict(order=1, solver="mpt", steps=100, approx=False), None),
    "fermat_sigmoid": ("square", dict(min_order=0, max_order=1, solver="fermat", steps=100,
                                      function=sigmoid), None),
    "two_tx": ("two_tx", dict(order=1, solver="fermat", steps=100), None),
    "tx_grid": ("square", dict(order=1, solver="fermat", steps=100, on_transmitters=True),
                None),
    "ris_vertex": ("ris_vertex", dict(order=1, solver="mpt", steps=300),
                   {1: np.array([[4]], np.int32)}),
    "zero_wall": ("zero_wall", dict(order=1, solver="mpt", steps=100), None),
}


@pytest.mark.parametrize("case", sorted(_SOLVER_TWIN_CASES))
def test_redesigned_solver_kernel_equals_its_twin(cuda, case):
    """opt_solver_value (shared reciprocals, its own RIS and wall loops,
    shared memory sized to the scene) against opt_solver_value_seq, the
    kernel before the redesign, bit for bit, on a 65 x 65 grid from 0 to 1
    (the zero-length wall's point is a pixel: unit()'s n2 == 0 branch)."""
    name, kw, groups = _SOLVER_TWIN_CASES[case]
    scene = _solver_scene(name, cuda)
    o = {**tr._OPTIONS, "approx": True, **kw, "key": prng.PRNGKey(1234)}
    if groups is None:
        groups = tr._groups_for(scene, o)
    x = torch.linspace(0.0, 1.0, 65, device=cuda)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    args = osk.solver_request(scene, X, Y, groups, **tr._solver_options(o))
    kkw = dict(approx=o["approx"], sigmoid=o["function"] is sigmoid)
    before, twins = osk.LAUNCHES["opt_solver_value"], osk.TWIN_LAUNCHES["opt_solver_value_seq"]
    v, tv = osk.value(*args, **kkw), osk.twin_value(*args, **kkw)
    torch.cuda.synchronize()
    n_tx = args[2].shape[0]
    assert osk.LAUNCHES["opt_solver_value"] == before + n_tx
    assert osk.TWIN_LAUNCHES["opt_solver_value_seq"] == twins + n_tx
    assert _same(v, tv)
    assert float(v.nan_to_num().abs().sum()) > 0.0


def _vag_twins(scene, n, kw, dev):
    o = {**tr._OPTIONS, **kw}
    groups = tr._groups_for(scene, o)
    sig = o["function"] is sigmoid
    target = scene.swap_ends() if o["on_transmitters"] else scene
    txs = torch.stack(list(target.transmitters.values())).contiguous()
    X, Y = torch.meshgrid(torch.linspace(0.03, 0.97, n, device=dev),
                          torch.linspace(0.02, 0.96, n, device=dev), indexing="xy")
    args = (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), txs, scene.walls,
            scene.kind, scene.phi, tuple(o[k] for k in tr._SCALAR_NAMES),
            pmk.kernel_inputs(groups, dev, approx=o["approx"], sigmoid=sig))
    kkw = dict(approx=o["approx"], sigmoid=sig)
    before, twins = pmk.LAUNCHES["power_map_vag"], pmk.TWIN_LAUNCHES["power_map_vag_seq"]
    (v, g), (tv, tg) = pmk.value_and_grad(*args, **kkw), pmk.twin_value_and_grad(*args, **kkw)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES["power_map_vag"] == before + 1
    assert pmk.TWIN_LAUNCHES["power_map_vag_seq"] == twins + 1
    assert _same(v, tv) and _same(g, tg)
    assert float(v.nan_to_num().abs().sum()) > 0.0


_VAG_TWIN_CASES = {
    "basic": ("basic", dict(max_order=1, approx=True)),
    "hard": ("basic", dict(max_order=1, approx=False)),
    "sigmoid": ("basic", dict(max_order=1, approx=True, function=sigmoid)),
    "ris_vertex": ("mixed", dict(max_order=1, approx=True)),
    "two_tx": ("two_tx", dict(max_order=1, approx=True)),
    "tx_grid": ("basic", dict(max_order=1, approx=True, on_transmitters=True)),
    "order2": ("basic", dict(max_order=2, approx=True)),
    "duplicated_wall": ("duplicated", dict(max_order=2, approx=True)),
    "short_walls": ("short", dict(max_order=1, approx=True)),
    "short_walls_sigmoid": ("short", dict(max_order=1, approx=True, function=sigmoid)),
}


@pytest.mark.parametrize("case", sorted(_VAG_TWIN_CASES))
def test_redesigned_vag_kernel_equals_its_twin(cuda, case):
    """power_map_vag (the looped kernels' redesigned sweep over all walls)
    against power_map_vag_seq, the sequential sweep, bit for bit on value
    and gradient, on a 48 x 48 grid (a ragged last warp)."""
    name, kw = _VAG_TWIN_CASES[case]
    scene = {
        "basic": lambda: Scene.basic_scene(device=cuda),
        "mixed": lambda: Scene.square_scene(device=cuda).add_ris(
            [[0.5, 0.3], [0.5, 0.7]]).add_vertex([0.25, 0.75]),
        "two_tx": lambda: Scene.basic_scene(device=cuda).update_transmitters(tx2=[0.8, 0.8]),
        "duplicated": lambda: _duplicated_wall(cuda),
        "short": lambda: _short_walls(cuda),
    }[name]()
    _vag_twins(scene, 47, kw, cuda)


@pytest.mark.parametrize("mode", ["hard_sigmoid", "sigmoid"])
def test_short_walls_looped_kernels_equal_their_twins(cuda, mode):
    """Blocked tests with |den| between 2^-126 and the rejection's 2^-90:
    the redesigned looped kernels against their sequential twins, bit for
    bit, at orders 1 and 2 (the saturated tests' partials are finite)."""
    for max_order in (1, 2):
        _check_twins(_short_walls(cuda), 20, True, mode == "sigmoid", cuda, max_order)
