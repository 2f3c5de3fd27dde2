"""Zero-gradient illustration (EuCAP2024 figure) on the PyTorch/CUDA port.

The port's counterpart of ``papers/eucap2024/plot_zero_gradient.py``: with
hard (non-approximated) logic the line-of-sight coverage map of the
square scene with a wall is piecewise constant, so the gradient of the
received power with respect to the receiver is zero almost everywhere --
the motivation for the smoothed logic.  The map runs on the unrolled value
kernel (``power_map_value``).  :func:`compute` makes the arrays, ``main``
plots them (matplotlib is needed for the plot only).
"""

import argparse

import torch

from differt2d_tpu_torch.defaults import resolve_device
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.tracer import power_map
from differt2d_tpu_torch.utils import P0


def compute(resolution: int = 600, device="cuda") -> dict:
    """The scene, its ``resolution`` x ``resolution`` grid ``X``, ``Y`` and the
    order-0 hard-logic map ``P``."""
    dev = resolve_device(device)
    scene = Scene.square_scene_with_wall(device=dev)
    X, Y = scene.grid(resolution)
    P = power_map(scene, X, Y, max_order=0, approx=False, device=dev)
    return {"scene": scene, "X": X, "Y": Y, "P": P}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resolution", type=int, default=600)
    parser.add_argument("--output", type=str, default="zero_gradient.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    out = compute(args.resolution, args.device)
    import matplotlib.pyplot as plt

    X, Y = out["X"].cpu(), out["Y"].cpu()
    PdB = 10.0 * torch.log10(out["P"].cpu() / P0 + torch.finfo(torch.float32).eps)

    fig, ax = plt.subplots(figsize=(6.4, 3.84))
    out["scene"].plot(ax, receivers=False)
    im = ax.pcolormesh(X, Y, PdB, vmin=-50, vmax=5, rasterized=True, zorder=-1)
    cbar = fig.colorbar(im, ax=ax)
    cbar.ax.set_ylabel("Power (dB)")
    ax.annotate(r"$\nabla = 0$", (0.6, 0.5))
    ax.set_xlabel("x coordinate")
    ax.set_ylabel("y coordinate")
    plt.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
