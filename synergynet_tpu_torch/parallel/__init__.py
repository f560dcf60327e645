"""Scale-out: the process group, the mesh's cliques, the tensor-parallel
dense decode and data-parallel serving.

Counterpart of ``synergynet_tpu/parallel/__init__.py``. Where the JAX
package runs one SPMD program over a ``jax.sharding.Mesh`` and XLA inserts
the collectives, the port runs one process per rank of a
``torch.distributed`` process group, each with its place on a
``(data, model)`` :class:`~synergynet_tpu_torch.core.mesh.Mesh`, and
calls the collectives itself:

- data parallel: each data row takes its block of the batch; the train
  step averages the gradient over the data group
  (:func:`synergynet_tpu_torch.train.jit_train_step`);
- tensor parallel: each model column holds one vertex slab of the dense
  basis and decodes it with kernel B1 (:func:`tp_dense_decode`);
- multi-process: :func:`init_distributed` joins the group (NCCL between
  cards, gloo on the CPU or where the caller asks).
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional

import torch
import torch.distributed as dist

from synergynet_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, make_mesh, batch_sharding, replicated,
    vertex_sharding, shard_batch, replicate,
)
from synergynet_tpu_torch.mm3d.assets import ParamPack

# How long a collective (and the rendezvous) waits for a missing rank.
TIMEOUT = datetime.timedelta(seconds=300)


def init_method(coordinator_address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a multi-process job: ``init_process_group`` with the
    coordinator's address, the world size and this process's rank, all
    given explicitly (nothing here reads a cluster's environment). A
    no-op for ``num_processes`` None or 1.

    ``backend``: "nccl" for ranks on cards, "gloo" for ranks on the CPU
    (or ranks that share one card); None picks NCCL where there is a card
    and gloo where there is not."""
    if num_processes in (None, 1):
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process job needs coordinator_address and "
                         "process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method(
        coordinator_address), world_size=num_processes, rank=process_id,
        timeout=TIMEOUT)


def warm_mesh_cliques(mesh) -> None:
    """Run one collective on each data and model group of the mesh, one
    group at a time, in the order :func:`make_mesh` made them, on every
    rank. Concurrent creation of several cross-process gloo contexts
    deadlocked under gVisor (``synergynet_tpu/parallel/__init__.py:49-59``);
    after this every context exists. A no-op outside a process group."""
    if not mesh.groups:
        return
    barrier = torch.zeros(1, device=mesh.device)
    for _, ranks, group in mesh.groups:
        if mesh.rank in ranks:
            ones = torch.ones(1, device=mesh.device)
            dist.all_reduce(ones, group=group)
            if float(ones) != len(ranks):
                raise RuntimeError(f"clique {ranks}: all_reduce gave "
                                   f"{float(ones)}")
        dist.all_reduce(barrier)


def tp_dense_decode(mesh, pack: ParamPack) -> Callable:
    """Tensor-parallel dense decode over the mesh's model axis.

    Each model column holds a contiguous copy of its vertex slab of the
    coordinate-split basis (``build_decode_basis(pack)``, Npad vertices
    split into ``n_model`` equal slabs, on the rank's device; each slab's
    width must be even, as kernel B1 stages the basis in 16-byte chunks).
    Returns ``decode(params (B, 62)) -> (slab (B, 3, Npad / n_model),
    checksum (B, 3))``: the rank's faces (its data row's block of the
    batch) decoded over its slab by kernel B1 on the card (its plain twin
    on the CPU), pad vertices included as in the JAX program, and the sum
    of every vertex coordinate ``all_reduce``d over the model group. The
    slab's vertex range is ``decode.vertex_range``."""
    from synergynet_tpu_torch.core.mesh import vertex_sharding
    from synergynet_tpu_torch.ops.fused_decode import (DecodeBasis,
                                                       build_decode_basis,
                                                       decode_dense_fused)
    dev = mesh.device
    basis = build_decode_basis(pack)
    sl = vertex_sharding(mesh).local_slice(basis.npad)
    width = sl.stop - sl.start
    if width % 2:
        raise ValueError(f"a vertex slab of {width} columns: kernel B1 needs "
                         "an even slab width")
    slab = DecodeBasis(basis.w[:, sl].contiguous().to(dev),
                       basis.u[:, sl].contiguous().to(dev), width)
    stats = pack._replace(u=pack.u[:0], w_shp=pack.w_shp[:0],
                          w_exp=pack.w_exp[:0]).to(dev)

    def decode(params: torch.Tensor):
        out = decode_dense_fused(params.to(dev), slab, stats)
        checksum = out.sum(dim=2)
        if mesh.model_group is not None:
            dist.all_reduce(checksum, group=mesh.model_group)
        return out, checksum

    decode.vertex_range = (sl.start, sl.stop)
    decode.basis = slab
    return decode


def shard_fused_engine(engine, mesh) -> Callable:
    """Data-parallel multi-frame serving: returns ``run(frames (B, H, W,
    3), frames_s2d, true_hws)`` that runs ``engine.process_batch`` on this
    rank's data-row block of the B frames (B divisible by the data size),
    on the engine's device, with no collective; it returns that block's
    outputs."""
    from synergynet_tpu_torch.core.mesh import batch_sharding
    dev = engine.api.device

    def run(frames, frames_s2d, true_hws):
        sl = batch_sharding(mesh).local_slice(frames.shape[0])
        return engine.process_batch(*(torch.as_tensor(x[sl]).to(dev)
                                      for x in (frames, frames_s2d,
                                                true_hws)))

    return run
