"""RIS power-map paper figure (JOSS) on the PyTorch/CUDA port.

The port's counterpart of ``papers/joss/plot_ris_power_map.py``: the beam
of a metasurface (RIS) at publication resolution, traced with the MPT
solver (1000 adam steps, key ``PRNGKey(1234)``) over RIS-only candidates,
on the order-1 solver kernel (``opt_solver_value``).  :func:`compute` makes
the arrays, ``main`` plots them (matplotlib is needed for the plot only).
"""

import argparse

import torch

from differt2d_tpu_torch import prng
from differt2d_tpu_torch.defaults import resolve_device
from differt2d_tpu_torch.geometry import RIS
from differt2d_tpu_torch.scene import Scene
from differt2d_tpu_torch.tracer import power_map
from differt2d_tpu_torch.utils import P0


def compute(resolution: int = 300, device="cuda") -> dict:
    """The scene, its grid ``X``, ``Y`` and the RIS map ``Z``."""
    dev = resolve_device(device)
    ris = RIS(xys=torch.tensor([[0.5, 0.3], [0.5, 0.7]], device=dev))
    scene = Scene.square_scene(device=dev).add_objects(ris)
    X, Y = scene.grid(resolution)
    Z = power_map(
        scene,
        X,
        Y,
        order=1,
        solver="mpt",
        steps=1000,
        approx=True,
        key=prng.PRNGKey(1234),
        filter_objects=lambda o: isinstance(o, RIS),
        device=dev,
    )
    return {"scene": scene, "X": X, "Y": Y, "Z": Z}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resolution", type=int, default=300)
    parser.add_argument("--output", type=str, default="ris_power_map.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    out = compute(args.resolution, args.device)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    out["scene"].plot(ax)
    dB = 10.0 * torch.log10(out["Z"].cpu() / P0 + torch.finfo(torch.float32).eps)
    im = ax.pcolormesh(out["X"].cpu(), out["Y"].cpu(), dB, vmin=-50, vmax=5, rasterized=True,
                       zorder=-1)
    fig.colorbar(im, ax=ax, label="Power (dB)")
    plt.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
