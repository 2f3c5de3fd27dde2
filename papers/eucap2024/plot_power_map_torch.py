"""Power-map paper figure (EuCAP2024) on the PyTorch/CUDA port.

The port's counterpart of ``papers/eucap2024/plot_power_map.py``: hard and
soft order-1 coverage maps of the basic scene side by side at publication
resolution, each on the unrolled value kernel (``power_map_value``).
:func:`compute` makes the arrays, ``main`` plots them (matplotlib is needed
for the plot only).
"""

import argparse

import torch

from differt2d_tpu_torch import prng
from differt2d_tpu_torch.defaults import resolve_device
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.tracer import power_map
from differt2d_tpu_torch.utils import P0


def compute(resolution: int = 600, device="cuda") -> dict:
    """The scene, its grid ``X``, ``Y`` and the order <= 1 maps ``Z`` by
    ``approx`` (``{False: hard, True: soft}``), key ``PRNGKey(1234)``."""
    dev = resolve_device(device)
    scene = Scene.basic_scene(device=dev)
    X, Y = scene.grid(resolution)
    key = prng.PRNGKey(1234)
    Z = {approx: power_map(scene, X, Y, max_order=1, approx=approx, key=key, device=dev)
         for approx in (False, True)}
    return {"scene": scene, "X": X, "Y": Y, "Z": Z}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resolution", type=int, default=600)
    parser.add_argument("--output", type=str, default="power_map.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    out = compute(args.resolution, args.device)
    import matplotlib.pyplot as plt

    X, Y = out["X"].cpu(), out["Y"].cpu()
    fig, axes = plt.subplots(1, 2, sharey=True, figsize=(10, 4.2))
    for ax, approx in zip(axes, (False, True)):
        dB = 10.0 * torch.log10(out["Z"][approx].cpu() / P0 + torch.finfo(torch.float32).eps)
        out["scene"].plot(ax, annotate=False)
        im = ax.pcolormesh(X, Y, dB, vmin=-50, vmax=5, rasterized=True, zorder=-1)
        ax.set_title("with approximation" if approx else "without approximation")
        ax.set_xlabel("x coordinate")
    axes[0].set_ylabel("y coordinate")
    fig.colorbar(im, ax=axes, label="Power (dB)")
    fig.savefig(args.output, dpi=150)
    print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
