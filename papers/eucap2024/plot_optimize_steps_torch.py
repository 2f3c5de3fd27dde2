"""Optimization-steps figure (EuCAP2024) on the PyTorch/CUDA port.

The port's counterpart of ``papers/eucap2024/plot_optimize_steps.py``:
transmitter placement on the square scene with an obstacle, maximizing the
minimum normalized power over two receivers, with hard logic (stuck in
the zero-gradient region) against soft logic with the sharpness annealed
on ``logspace(0, 2, steps)`` (which escapes it).  Each step takes the
gradient of :meth:`Scene.accumulate_over_paths` by autograd and an adam
step of 0.01 with optax's arithmetic, a NaN update element set to 0
(``optax.chain(adam(0.01), zero_nans())``, :class:`~differt2d_tpu_torch.optimize.OptaxAdam`).
This path is the object API; it launches no kernel.  :func:`compute` makes
the arrays, ``main`` plots them (matplotlib is needed for the plot only).
"""

import argparse

import torch

from differt2d_tpu_torch.defaults import resolve_device
from differt2d_tpu_torch.geometry import Point
from differt2d_tpu_torch.optimize import OptaxAdam
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.utils import P0, received_power


def make_loss(scene, approx: bool):
    """``(value, gradient)`` of ``-min over receivers of power / P0`` with
    respect to the transmitter's coordinates, at ``alpha``."""

    def loss(tx_coords, alpha):
        s = scene.with_transmitters(tx=Point(xy=tx_coords))
        acc = torch.tensor(float("inf"), device=tx_coords.device)
        for _, _, power in s.accumulate_over_paths(
            received_power, max_order=1, approx=approx, alpha=alpha
        ):
            acc = torch.minimum(acc, power / P0)
        return -acc

    def value_and_grad(tx, alpha):
        tx = tx.detach().requires_grad_(True)
        value = loss(tx, alpha)
        (grad,) = torch.autograd.grad(value, tx)
        return value.detach(), grad

    return value_and_grad


def make_scene(device):
    """The figure's scene: the square with an obstacle, TX ``Tx`` at
    (0.5, 0.7) and the receivers ``rx_0``, ``rx_1``."""
    scene = Scene.square_scene_with_obstacle(device=device)
    scene = scene.with_transmitters(Tx=Point(xy=torch.tensor([0.5, 0.7], device=device)))
    return scene.with_receivers(
        rx_0=Point(xy=torch.tensor([0.3, 0.1], device=device)),
        rx_1=Point(xy=torch.tensor([0.5, 0.1], device=device)),
    )


def descend(scene, approx: bool, alphas: torch.Tensor) -> tuple:
    """``(trajectory [len(alphas) + 1, 2], losses)``: one adam step per
    alpha from (0.5, 0.7).  The first ``k`` steps do not depend on the
    alphas after the ``k``-th."""
    f_and_df = make_loss(scene, approx)
    tx = torch.tensor([0.5, 0.7], device=scene.device)
    optimizer = OptaxAdam(0.01, len(alphas))
    traj, losses = [tx], []
    for alpha in alphas:
        value, grads = f_and_df(tx, alpha)
        tx = optimizer.step(tx, grads)
        traj.append(tx)
        losses.append(float(value))
    return torch.stack(traj), losses


def compute(steps: int = 100, device="cuda") -> dict:
    """The scene, the ``alphas`` and, by ``approx`` (``False``: hard,
    ``True``: soft), the transmitter ``trajectories`` (``[steps + 1, 2]``)
    and the ``losses`` of each step."""
    dev = resolve_device(device)
    scene = make_scene(dev)
    alphas = torch.logspace(0, 2, steps, device=dev)
    trajectories, losses = {}, {}
    for approx in (False, True):
        trajectories[approx], losses[approx] = descend(scene, approx, alphas)
        print(f"approx={approx}: final TX {trajectories[approx][-1].tolist()},"
              f" final loss {losses[approx][-1]:.5f}")
    return {"scene": scene, "alphas": alphas, "trajectories": trajectories, "losses": losses}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--output", type=str, default="optimize_steps.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    out = compute(args.steps, args.device)
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.5))
    out["scene"].plot(ax1)
    for approx, color in ((False, "red"), (True, "purple")):
        traj = out["trajectories"][approx].cpu()
        ax1.plot(traj[:, 0], traj[:, 1], "-o", markersize=2, color=color,
                 label=f"approx={approx}")
    ax1.legend()
    ax1.set_title("TX trajectories")
    for approx, color in ((False, "red"), (True, "purple")):
        ax2.plot(out["losses"][approx], color=color, label=f"approx={approx}")
    ax2.set_xlabel("step")
    ax2.set_ylabel("loss (-min normalized power)")
    ax2.legend()
    plt.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
