"""Pixel sharding of the power map over ``torch.distributed`` ranks, and the
sharded training step.

Counterpart of ``differt2d_tpu/parallel/sharding.py``.  The JAX package lays
the pixel axis over a device ``Mesh`` and lets XLA's SPMD partitioner place
the collectives.  Here each rank is a process with one device (NCCL on
GPUs, one rank per ``cuda:{local_rank}``; gloo on the CPU), a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose dimensions name
process groups, a shard is a plain local tensor, and the collectives are
written out:

* :func:`power_map_sharded`: each rank maps its block of whole grid rows
  with :func:`~differt2d_tpu_torch.tracer.power_map` (on the card the
  unrolled kernels B1/B2, the looped city kernels or the solver kernel),
  and one all-gather returns the whole map on every rank;
* :func:`make_train_step`: the same gathered map feeds the loss on every
  rank, and the backward all-reduces the parameter gradients once.

Autograd follows JAX's rules for an SPMD program whose loss is the same on
every rank: the gather's backward keeps the rank's own rows of the output
gradient, and the replicated inputs (scene tensors, parameters) enter
through :func:`replicated`, whose backward sums their gradients over the
mesh, so every rank ends with the single-device gradient.

With gloo, a collective on CUDA tensors goes through host copies (two ranks
sharing one card, where NCCL refuses to run).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .. import tracer as _tracer
from .._runtime_typing import unchecked
from .._tree import tree_flatten, tree_unflatten
from ..defaults import DEFAULT_DEVICE, resolve_device

# Renamed in later PyTorch releases; the old name warns there.
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _require_initialized() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        msg = ("torch.distributed is not initialized: call initialize_distributed or"
               " initialize_from_env first")
        raise RuntimeError(msg)


def mesh_device_type() -> str:
    """Device type of the meshes of this process group: ``"cuda"`` under
    NCCL, ``"cpu"`` under gloo (also with CUDA tensors, which gloo's
    collectives here take through the host)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def grid_mesh(axis_name: str = "grid"):
    """1-D mesh over every rank, on the pixel (``"grid"``) axis.

    Needs an initialized process group (:func:`initialize_distributed`).
    """
    from torch.distributed.device_mesh import init_device_mesh

    _require_initialized()
    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


# -- collectives ------------------------------------------------------------------


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(local: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``local`` tensors (one shape on every rank) concatenated
    along the first axis, in group-rank order, on every rank."""
    src = local.detach().contiguous()
    host = _through_host(src, group)
    if host:
        src = src.cpu()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0], *src.shape[1:]))
    _gather_single(out, src, group=group)
    return out.to(local.device) if host else out


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the group of the ranks' ``t``, in a new tensor."""
    host = _through_host(t, group)
    out = t.detach().cpu() if host else t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.device) if host else out


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather`; backward: the rank's own rows of the gradient."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group, ctx.rows = group, local.shape[0]
        return all_gather(local, group)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start : start + ctx.rows], None


class _SumOver(torch.autograd.Function):
    """:func:`all_reduce` (sum); backward: the gradient as it is (the loss,
    made from the sum, is the same on every rank)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    """Identity on the replicated inputs; backward: their gradients summed
    over each group of ``groups``, in one flat all-reduce per group."""

    @staticmethod
    def forward(ctx, groups, *tensors):
        ctx.groups = groups
        return tuple(t.clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        dev = grads[0].device
        flat = torch.cat([g.reshape(-1).to(dev) for g in grads])
        for group in ctx.groups:
            flat = all_reduce(flat, group)
        out, start = [], 0
        for g in grads:
            out.append(flat[start : start + g.numel()].reshape(g.shape).to(g.device))
            start += g.numel()
        return (None, *out)


def _tracked(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def replicated(tensors: Sequence, groups: Sequence) -> list:
    """``tensors`` as the inputs of a computation split over ``groups``:
    the same values, whose gradients the backward sums over the groups.
    Tensors autograd does not track, and all of them with grad mode off,
    come back as they are."""
    tensors = list(tensors)
    at = [i for i, t in enumerate(tensors) if _tracked(t)]
    if at and torch.is_grad_enabled():
        for i, t in zip(at, _Replicate.apply(tuple(groups), *(tensors[i] for i in at))):
            tensors[i] = t
    return tensors


def replicated_request(scene, X, Y, options: dict, groups: Sequence) -> tuple:
    """``(scene, X, Y, options)`` with each tracked tensor, of the scene
    (walls, RIS phases, transmitters, receivers), the grids and the scalar
    options, passed through :func:`replicated` over ``groups``."""
    names = [n for n in _tracer._SCALAR_NAMES if _tracked(options.get(n))]
    tx, rx = list(scene.transmitters), list(scene.receivers)
    values = [scene.walls, scene.phi, X, Y, *scene.transmitters.values(),
              *scene.receivers.values(), *(options[n] for n in names)]
    if not any(_tracked(v) for v in values):
        return scene, X, Y, options
    walls, phi, X, Y, *rest = replicated(values, groups)
    scene = scene.replace(walls=walls, phi=phi,
                          transmitters=dict(zip(tx, rest[: len(tx)])),
                          receivers=dict(zip(rx, rest[len(tx) : len(tx) + len(rx)])))
    options = {**options, **dict(zip(names, rest[len(tx) + len(rx) :]))}
    return scene, X, Y, options


# -- shards ------------------------------------------------------------------------


def local_block(t: torch.Tensor, group) -> torch.Tensor:
    """The group rank's block of ``t``'s first axis, cut into equal blocks
    after padding with copies of the last entry (as ``shard_pixels`` pads
    with the last pixel): equal shapes on every rank, as the all-gather
    needs."""
    k, r = dist.get_world_size(group), dist.get_rank(group)
    per = -(-t.shape[0] // k)
    block = t[r * per : (r + 1) * per]
    short = per - block.shape[0]
    if short:
        block = torch.cat([block, t[-1:].expand(short, *t.shape[1:])])
    return block


def shard_pixels(pixels, mesh=None, axis_name: str = "grid") -> tuple[torch.Tensor, int]:
    """This rank's shard of the flat pixel batch ``pixels[P, 2]``, padded
    with copies of the last pixel to an equal shard on every rank, and
    ``P``.

    Padding pixels are mapped like real ones; the sharded maps drop them
    after the gather.
    """
    if mesh is None:
        mesh = grid_mesh(axis_name)
    pixels = torch.as_tensor(pixels)
    return local_block(pixels, mesh.get_group(axis_name)), pixels.shape[0]


def gather_shards(local: torch.Tensor, n: int, mesh=None, axis_name: str = "grid"):
    """The whole ``[n, ...]`` result of the ranks' shards ``local`` (from
    :func:`shard_pixels` or ``host_local_pixels``), on every rank: one
    all-gather, the padding dropped.  Differentiable: the backward keeps
    the rank's own rows."""
    if mesh is None:
        mesh = grid_mesh(axis_name)
    return _GatherRows.apply(local, mesh.get_group(axis_name))[:n]


def _grids(X, Y, dev) -> tuple:
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    Y = torch.as_tensor(Y).to(device=dev, dtype=torch.float32)
    if X.dim() != 2 or X.shape != Y.shape:
        msg = f"X and Y must be equal 2-D grids, got {tuple(X.shape)} and {tuple(Y.shape)}"
        raise ValueError(msg)
    return X, Y


def pack(out, grad: bool, value_and_grad: bool) -> torch.Tensor:
    """A map's result (grid-shaped or flat) as one ``[P, c]`` tensor (one
    collective moves it)."""
    if value_and_grad:
        return torch.cat([out[0].reshape(-1, 1), out[1].reshape(-1, 2)], dim=1)
    return out.reshape(-1, 2) if grad else out.reshape(-1, 1)


def unpack(flat: torch.Tensor, shape: tuple, grad: bool, value_and_grad: bool):
    """Inverse of :func:`pack`, reshaped to the grid ``shape``."""
    if value_and_grad:
        return flat[:, 0].reshape(shape), flat[:, 1:].reshape(*shape, 2)
    return flat.reshape(*shape, 2) if grad else flat.reshape(shape)


def power_map_sharded(
    scene,
    X,
    Y,
    *,
    mesh=None,
    axis_name: str = "grid",
    grad: bool = False,
    value_and_grad: bool = False,
    backend: str = "auto",
    device=DEFAULT_DEVICE,
    **kwargs: Any,
):
    """:func:`~differt2d_tpu_torch.tracer.power_map` over the ranks of
    ``mesh``'s ``axis_name`` (default: every rank).

    Every rank passes the whole ``X``/``Y`` grid.  The grid is cut into
    equal blocks of whole rows (the last row repeated where the ranks do not
    divide the rows), each rank maps its block by ``power_map``'s route
    (``backend`` as there: ``"auto"``, ``"torch"`` or ``"cuda"``), and one
    all-gather returns the whole map, equal to ``power_map``'s bit for bit,
    on every rank.  Whole rows keep the looped route's 16 x 16 tiles.

    The value map is differentiable with respect to the scene, the grids
    and tensor options: every rank gets the single-device gradient of a
    loss computed alike on every rank.
    """
    dev = resolve_device(device)
    if mesh is None:
        mesh = grid_mesh(axis_name)
    group = mesh.get_group(axis_name)
    X, Y = _grids(X, Y, dev)
    scene, X, Y, kwargs = replicated_request(scene.to(dev), X, Y, kwargs, [group])
    out = unchecked(_tracer.power_map)(
        scene, local_block(X, group), local_block(Y, group), grad=grad,
        value_and_grad=value_and_grad, backend=backend, device=dev, **kwargs)
    flat = _GatherRows.apply(pack(out, grad, value_and_grad), group)
    return unpack(flat[: X.numel()], X.shape, grad, value_and_grad)


def make_train_step(
    scene_builder: Callable[[Any], Any],
    optimizer: torch.optim.Optimizer,
    *,
    objective: str = "min_power",
    mesh=None,
    axis_name: str = "grid",
    cols: Optional[int] = None,
    backend: str = "auto",
    device=DEFAULT_DEVICE,
    **trace_kwargs: Any,
):
    """A training step for TX placement or RIS phases over a sharded grid
    (``differt2d_tpu.parallel.make_train_step``).

    ``scene_builder(params)`` returns a scene made from the ``params`` tree
    (a dict of tensors, say) whose leaves ``optimizer`` updates.  The loss
    is computed alike on every rank from the whole map of the pixels:

    * ``"min_power"``: ``-min`` (maximise the weakest receiver; the gradient
      of a tie is split equally among the equal pixels of every rank, as
      JAX's ``reduce_min`` does);
    * ``"sum_power"``: ``-sum``.

    :return: ``step(params, pixels, alpha) -> loss``: ``pixels`` is this
        rank's shard (:func:`shard_pixels`; rows ``cols`` wide where it is
        a block of grid rows, as :func:`host_local_pixels` gives), mapped
        through ``power_map``'s route; the gathered map includes the
        padding pixels, as the JAX step's sharded input does.  The backward
        all-reduces the parameter gradients once; then ``optimizer.step()``
        runs, and any element it turns NaN keeps its old value (the update
        of ``optax.chain(optimizer, optax.zero_nans())``: a receiver on a
        wall has a NaN gradient).  ``params`` are updated in place.
    """
    if objective not in ("min_power", "sum_power"):
        msg = f"objective must be 'min_power' or 'sum_power', got {objective!r}"
        raise ValueError(msg)
    dev = resolve_device(device)
    _tracer._options({**trace_kwargs, "alpha": 1.0}, backend)
    if mesh is None:
        mesh = grid_mesh(axis_name)
    group = mesh.get_group(axis_name)

    def step(params, pixels, alpha):
        optimizer.zero_grad(set_to_none=True)
        leaves, spec = tree_flatten(params)
        scene = scene_builder(tree_unflatten(spec, replicated(leaves, [group])))
        run = _tracer.make_pixels_fn(scene, alpha=alpha, backend=backend, device=dev,
                                     cols=cols, **trace_kwargs)
        powers = _GatherRows.apply(run(pixels), group)
        loss = -powers.min() if objective == "min_power" else -powers.sum()
        loss.backward()
        with torch.no_grad():
            before = [p.detach().clone() for p in leaves]
            optimizer.step()
            for p, old in zip(leaves, before):
                p.copy_(torch.where(torch.isnan(p), old, p))
        return loss.detach()

    return step


def initialize_distributed(
    *, device=DEFAULT_DEVICE, backend: Optional[str] = None, **kwargs: Any
) -> torch.device:
    """Join the process group (``torch.distributed.init_process_group``
    with ``kwargs``: ``init_method``, ``world_size``, ``rank``, ...) and
    return this rank's device.

    On GPUs (``device="cuda"``, the default, which raises without one) the
    backend is NCCL and the rank takes ``cuda:{local_rank}`` (``LOCAL_RANK``
    of the environment, else the rank, modulo the visible cards); on the
    CPU it is gloo.  ``backend="gloo"`` with CUDA tensors runs several
    ranks on one card (their collectives go through the host).
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kwargs)
    return dev
