"""The (data, model) mesh over the ranks of a process group.

Counterpart of ``synergynet_tpu/core/mesh.py``. Where the JAX package lays
a ``jax.sharding.Mesh`` over devices and lets XLA insert the ``psum``
collectives, the port gives each rank of a ``torch.distributed`` process
group one device and one place on a ``(data, model)`` grid:

- rank ``r`` sits at data row ``r // n_model`` and model column
  ``r % n_model``, as JAX's ``reshape(n_data, n_model)`` places devices;
- its **data group** is the column it sits in (the ranks that hold
  different rows of the batch: gradients and synchronized BatchNorm
  statistics are reduced over it), its **model group** the row (the
  ranks that hold different vertex slabs of the dense basis);
- ``batch_sharding`` / ``replicated`` / ``vertex_sharding`` name which
  axis an array is split over; :func:`shard_batch` moves a rank's own rows
  to its device and :func:`replicate` broadcasts a state from rank 0.

With no process group initialised the mesh is 1x1 on one device and
nothing here runs a collective.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from synergynet_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def distributed() -> bool:
    """True inside an initialised ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """One rank's view of a ``(data, model)`` grid of ranks.

    ``shape`` is ``{"data": n_data, "model": n_model}``; ``data_index`` and
    ``model_index`` are the rank's row and column; ``data_group`` and
    ``model_group`` its column's and row's process groups (None outside a
    process group); ``device`` the rank's device."""

    def __init__(self, n_data: int, n_model: int, rank: int,
                 device: torch.device, groups: Optional[list] = None):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, n_model)
        self.device = device
        # (axis, member ranks, group), in the order every rank made them.
        self.groups = groups or []
        self.data_group = self._mine(DATA_AXIS)
        self.model_group = self._mine(MODEL_AXIS)

    def _mine(self, axis):
        for ax, ranks, group in self.groups:
            if ax == axis and self.rank in ranks:
                return group
        return None

    def data_ranks(self) -> List[int]:
        """The global ranks of this rank's data group, row 0 first."""
        n_data, n_model = self.shape[DATA_AXIS], self.shape[MODEL_AXIS]
        return [d * n_model + self.model_index for d in range(n_data)]

    def model_ranks(self) -> List[int]:
        """The global ranks of this rank's model group, column 0 first."""
        n_model = self.shape[MODEL_AXIS]
        return [self.data_index * n_model + m for m in range(n_model)]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device="cuda") -> Mesh:
    """This rank's place on an ``n_data x n_model`` mesh over the process
    group's ranks (one rank, 1x1, outside a process group). ``n_data``
    defaults to every rank over ``n_model``. The data and model groups are
    made here, in the same order on every rank, as ``new_group`` needs.

    ``device``: the rank's device, the card unless the caller asks for the
    CPU; a bare "cuda" is card ``rank % device_count``."""
    world = dist.get_world_size() if distributed() else 1
    rank = dist.get_rank() if distributed() else 0
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{world} devices not divisible by "
                             f"n_model={n_model}")
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs more than {world} devices")
    if n_data * n_model < world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves ranks "
                         f"{n_data * n_model}..{world - 1} outside it")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and distributed():
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    dev = resolve_device(dev)
    if not distributed():
        return Mesh(n_data, n_model, 0, dev)
    groups = []
    for col in range(n_model):
        ranks = [d * n_model + col for d in range(n_data)]
        groups.append((DATA_AXIS, ranks, dist.new_group(ranks)))
    for row in range(n_data):
        ranks = [row * n_model + m for m in range(n_model)]
        groups.append((MODEL_AXIS, ranks, dist.new_group(ranks)))
    return Mesh(n_data, n_model, rank, dev, groups)


class Sharding(NamedTuple):
    """Which axis of the mesh an array's leading (or vertex) axis is split
    over: ``DATA_AXIS``, ``MODEL_AXIS`` or None (replicated)."""

    mesh: Mesh
    axis: Optional[str]

    def local_slice(self, n: int) -> slice:
        """This rank's contiguous block of an extent ``n`` split over the
        axis (all of it when replicated)."""
        if self.axis is None:
            return slice(0, n)
        parts = self.mesh.shape[self.axis]
        if n % parts:
            raise ValueError(f"extent {n} not divisible by the {self.axis} "
                             f"axis ({parts})")
        i = (self.mesh.data_index if self.axis == DATA_AXIS
             else self.mesh.model_index)
        return slice(i * n // parts, (i + 1) * n // parts)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def vertex_sharding(mesh: Mesh) -> Sharding:
    """The vertex axis of the dense basis split over the model axis (the
    tensor-parallel dense decode)."""
    return Sharding(mesh, MODEL_AXIS)


def _map(tree: Any, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """A tree of this rank's own batch rows (numpy arrays or tensors, from
    the process-sharded loader) as tensors on the rank's device; the
    global batch is the data rows' blocks in row order, as JAX assembles
    it from process-local data."""
    def put(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        if mesh.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(mesh.device, non_blocking=True)
    return _map(tree, put)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast a state from rank 0 (data row 0, model column 0) to every
    rank, in place; returns it. ``tree`` is a tensor, a dict / list / tuple
    of them, or an object with ``tensors()`` (a ``TrainState``)."""
    if not distributed():
        return tree
    if hasattr(tree, "tensors"):
        for t in tree.tensors():
            dist.broadcast(t, src=0)
        return tree

    def bcast(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0)
        return t
    return _map(tree, bcast)
