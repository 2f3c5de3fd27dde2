"""Kernel tests that need an NVIDIA GPU (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q -p no:randomly

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: values at rtol 1e-4 / atol 1e-5, gradients under the kink contract
at rtol 1e-3 / atol 1e-5.
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
