"""Optimization-steps figure (JOSS paper) on the PyTorch/CUDA port.

The port's counterpart of ``papers/joss/plot_optimize_steps.py``: four
snapshots of the transmitter-placement optimization on the square scene
with an obstacle (soft logic, the sharpness annealed on
``logspace(0, 2, steps)``, adam 0.01 with optax's arithmetic and
``zero_nans``, :class:`~differt2d_tpu_torch.optimize.OptaxAdam`), each
snapshot's coverage map on the unrolled value kernel
(``power_map_value``).  :func:`compute` makes the arrays, ``main`` plots
them (matplotlib is needed for the plot only).
"""

import argparse

import torch

from differt2d_tpu_torch.defaults import resolve_device
from differt2d_tpu_torch.geometry import Point
from differt2d_tpu_torch.optimize import OptaxAdam
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.tracer import power_map
from differt2d_tpu_torch.utils import P0, received_power


def compute(steps: int = 80, resolution: int = 300, device="cuda") -> dict:
    """The transmitter's ``trajectory`` (``[steps + 1, 2]``) and the
    ``snapshots``: up to four dicts of ``alpha``, ``tx``, the scene with
    that transmitter, its grid ``X``, ``Y`` and its order <= 1 soft map
    ``Z`` at that alpha."""
    dev = resolve_device(device)
    scene = Scene.square_scene_with_obstacle(device=dev)
    scene = scene.with_receivers(
        rx_0=Point(xy=torch.tensor([0.3, 0.1], device=dev)),
        rx_1=Point(xy=torch.tensor([0.5, 0.1], device=dev)),
    )

    def loss(tx_coords, alpha):
        s = scene.with_transmitters(tx=Point(xy=tx_coords))
        acc = torch.tensor(float("inf"), device=dev)
        for _, _, power in s.accumulate_over_paths(
            received_power, max_order=1, approx=True, alpha=alpha
        ):
            acc = torch.minimum(acc, power / P0)
        return -acc

    optimizer = OptaxAdam(0.01, steps)
    tx = torch.tensor([0.5, 0.7], device=dev)
    trajectory, taken = [tx], []
    snap_every = max(1, steps // 4)
    for frame, alpha in enumerate(torch.logspace(0, 2, steps, device=dev)):
        if frame % snap_every == 0 and len(taken) < 4:
            taken.append((float(alpha), tx))
        x = tx.detach().requires_grad_(True)
        (grads,) = torch.autograd.grad(loss(x, alpha), x)
        tx = optimizer.step(tx, grads)
        trajectory.append(tx)

    snapshots = []
    for alpha, tx_snap in taken:
        s = scene.with_transmitters(tx=Point(xy=tx_snap))
        X, Y = s.grid(resolution)
        Z = power_map(s, X, Y, max_order=1, approx=True, alpha=alpha, device=dev)
        snapshots.append({"alpha": alpha, "tx": tx_snap, "scene": s, "X": X, "Y": Y, "Z": Z})
    return {"trajectory": torch.stack(trajectory), "snapshots": snapshots}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=80)
    parser.add_argument("--resolution", type=int, default=300)
    parser.add_argument("--output", type=str, default="optimize_steps.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    out = compute(args.steps, args.resolution, args.device)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, sharey=True, figsize=(14, 3.6))
    for ax, snap in zip(axes, out["snapshots"]):
        dB = 10.0 * torch.log10(snap["Z"].cpu() / P0 + torch.finfo(torch.float32).eps)
        snap["scene"].plot(ax, annotate=False)
        ax.pcolormesh(snap["X"].cpu(), snap["Y"].cpu(), dB, vmin=-50, vmax=5, rasterized=True,
                      zorder=-1)
        ax.set_title(f"$\\alpha = {snap['alpha']:.1f}$")
        ax.set_xlabel("x coordinate")
    axes[0].set_ylabel("y coordinate")
    plt.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
