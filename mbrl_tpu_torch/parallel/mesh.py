"""A (model, data) mesh of ranks on ``torch.distributed`` (counterpart of
``mbrl_tpu/parallel/mesh.py``).

One process per device: a JAX program over N devices in one process is N
ranks here, laid out row-major as ``(model, data)`` (rank ``r`` sits at
``(r // data, r % data)``, as ``np.reshape`` lays out the JAX mesh's devices):

  - ``model`` axis: ensemble members (each rank trains a block of members);
  - ``data`` axis: batch rows and rollout particles.

Each rank holds its own block of what ``NamedSharding`` would have placed on
its device. The collectives that XLA inserts are explicit here
(:meth:`Mesh.all_reduce`, :meth:`Mesh.gather`), and every one of them is an
all-reduce: under the ``gloo`` backend a CUDA tensor supports only
``broadcast`` and ``all_reduce``, so a gather is an all-reduce of zero-padded
buffers, which is exact (each element has one non-zero contributor).

With no process group (one process) the mesh is 1 x 1 and calls no
collective; :func:`make_mesh` never creates a process group itself.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mbrl_tpu_torch.ops.tree import tree_map

MODEL_AXIS = "model"
DATA_AXIS = "data"
AXES = (MODEL_AXIS, DATA_AXIS)


def process_info() -> Tuple[int, int]:
    """``(rank, world_size)`` of the process group, ``(0, 1)`` when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """This rank's place in the ``(model, data)`` grid and the process groups
    of its two axes (``None`` for an axis of size 1)."""

    def __init__(self, model_axis_size: int, data_axis_size: int, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], Any]] = None):
        self.shape = {MODEL_AXIS: model_axis_size, DATA_AXIS: data_axis_size}
        self.size = model_axis_size * data_axis_size
        self.rank = rank
        self.coords = {MODEL_AXIS: rank // data_axis_size, DATA_AXIS: rank % data_axis_size}
        self._groups = groups or {}

    def __repr__(self) -> str:
        return f"Mesh(model={self.shape[MODEL_AXIS]}, data={self.shape[DATA_AXIS]}, rank={self.rank})"

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def block(self, n: int, axis: str) -> slice:
        """This rank's contiguous block of ``n`` along ``axis``; raises when the
        axis does not divide ``n`` (as XLA rejects an uneven sharding)."""
        parts = self.shape[axis]
        if n % parts:
            raise ValueError(f"{n} does not divide over the {parts}-wide {axis!r} axis")
        size = n // parts
        start = self.coords[axis] * size
        return slice(start, start + size)

    def all_reduce(self, tensor: torch.Tensor, axes: Sequence[str] = AXES) -> torch.Tensor:
        """In-place sum of ``tensor`` over the ranks that share this rank's
        place on every axis but ``axes``; no collective when those ranks are
        this one alone."""
        axes = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if axes:
            group = None if len(axes) == 2 else self._groups[axes]
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        return tensor

    def gather(self, local: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The whole tensor from each rank's equal block along ``dim``, split
        over ``axis``: an all-reduce of zero-padded buffers."""
        parts = self.shape[axis]
        if parts == 1:
            return local
        shape = list(local.shape)
        size = shape[dim]
        shape[dim] = size * parts
        full = torch.zeros(shape, dtype=local.dtype, device=local.device)
        full.narrow(dim, self.coords[axis] * size, size).copy_(local)
        return self.all_reduce(full, (axis,))

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """Rank 0's values of ``tensor`` on every rank (in place)."""
        if self.size > 1:
            dist.broadcast(tensor, src=0)
        return tensor


def make_mesh(devices: Optional[Sequence[Any]] = None,
              model_axis_size: Optional[int] = None) -> Mesh:
    """The ``(model, data)`` mesh over the process group's ranks, one per
    device (``devices``, when given, must count one per rank).

    ``model_axis_size`` defaults to the largest of {2, 4} that divides the
    device count (1 when neither does), so small meshes keep a data axis.
    Creates the axes' groups with ``dist.new_group`` (every rank calls this in
    the same order); with no process group up, a 1 x 1 mesh and no group.
    """
    rank, world = process_info()
    n = world if devices is None else len(devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} processes, one per device; this run has {world} "
            "(start them with the MBRL_TPU_COORDINATOR, _NUM_PROCESSES and _PROCESS_ID variables)"
        )
    if model_axis_size is None:
        model_axis_size = 1
        for cand in (2, 4):
            if n % cand == 0:
                model_axis_size = cand
    if n % model_axis_size != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis_size}")
    data_axis_size = n // model_axis_size
    groups: Dict[Tuple[str, ...], Any] = {}
    if n > 1:
        grid = np.arange(n).reshape(model_axis_size, data_axis_size)
        # every rank creates every group, in one order, as new_group requires
        if data_axis_size > 1:
            rows = [dist.new_group(ranks=[int(r) for r in row]) for row in grid]
            groups[(DATA_AXIS,)] = rows[rank // data_axis_size]
        if model_axis_size > 1:
            cols = [dist.new_group(ranks=[int(r) for r in col]) for col in grid.T]
            groups[(MODEL_AXIS,)] = cols[rank % data_axis_size]
    return Mesh(model_axis_size, data_axis_size, rank, groups)


class Sharding:
    """Where a tensor lives on the mesh: dimension ``i`` is split over the axis
    ``spec[i]`` (``None``, or past the spec: whole on every rank), as JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, spec={self.spec})"

    @property
    def parts(self) -> int:
        """How many blocks the sharded dimensions make together."""
        return self.mesh.axes_size([a for a in self.spec if a is not None])

    def local(self, x):
        """This rank's block of ``x`` (a tensor or numpy array)."""
        for dim, axis in enumerate(self.spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                index = [slice(None)] * dim + [self.mesh.block(x.shape[dim], axis)]
                x = x[tuple(index)]
        return x


def ensemble_param_sharding(mesh: Mesh, ensemble_size: int):
    """Rule for a stacked-ensemble params tree: a floating leaf whose leading
    axis is the ensemble axis splits over ``model`` when the model axis divides
    ``ensemble_size``; every other leaf is whole on every rank (integer leaves,
    such as the elite indices, index the ensemble and are not per-member
    rows)."""
    model_size = mesh.shape[MODEL_AXIS]

    def rule(leaf) -> Sharding:
        if (
            isinstance(leaf, torch.Tensor)
            and leaf.is_floating_point()
            and leaf.ndim >= 1
            and leaf.shape[0] == ensemble_size
            and ensemble_size % model_size == 0
        ):
            return Sharding(mesh, (MODEL_AXIS,))
        return Sharding(mesh, ())

    return rule


def shard_ensemble_params(params: Any, mesh: Mesh, ensemble_size: int) -> Any:
    """This rank's block of the members of every member leaf."""
    rule = ensemble_param_sharding(mesh, ensemble_size)
    return tree_map(lambda x: rule(x).local(x), params)


def shard_member_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's block of an (E, B, ...) bootstrapped batch: members over
    ``model``, rows over ``data``; leaves of rank below 2 stay whole."""
    split = Sharding(mesh, (MODEL_AXIS, DATA_AXIS))
    return tree_map(lambda x: split.local(x) if x.ndim >= 2 else x, batch)


def shard_particles(batch: Any, mesh: Mesh) -> Any:
    """This rank's block of a (B, ...) particle or population batch, over ``data``."""
    split = Sharding(mesh, (DATA_AXIS,))
    return tree_map(split.local, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values of every tensor leaf on every rank (fresh tensors)."""
    if mesh.size == 1:
        return tree
    return tree_map(
        lambda x: mesh.broadcast(x.detach().clone().contiguous())
        if isinstance(x, torch.Tensor) else x,
        tree,
    )
