"""Default values and object kinds (counterpart of ``differt2d_tpu/defaults.py``
and the ``KIND_*`` constants of ``differt2d_tpu/tracer.py``)."""

from __future__ import annotations

import torch

DEFAULT_ALPHA: float = 100.0
"""Default slope for :func:`differt2d_tpu_torch.logic.activation`."""

DEFAULT_PATCH: float = 0.0
"""Default patch value for intersection checks (virtually grows/shrinks
walls in the blocked test)."""

DEFAULT_R_COEF: float = 0.5
"""Default real reflection coefficient."""

DEFAULT_HEIGHT: float = 0.1
"""Default TX antenna height; a numerical artifact avoiding division by zero
in the received-power model."""

DEFAULT_DEVICE: str = "cuda"
"""Entry points run on the GPU unless the caller asks for another device."""

KIND_WALL = 0
KIND_RIS = 1
KIND_VERTEX = 2


def resolve_device(device) -> torch.device:
    """Turn a ``device`` argument into a :class:`torch.device`.

    A CUDA device without a usable GPU raises instead of quietly running
    on the CPU: the CPU is only used when the caller asks for it.  A CUDA
    device gets its index (the current device), so that tensors compare
    equal to it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            msg = (
                f"device {str(dev)!r} requested but no CUDA device is available;"
                " pass device='cpu' to run the plain PyTorch path on the CPU"
            )
            raise RuntimeError(msg)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
