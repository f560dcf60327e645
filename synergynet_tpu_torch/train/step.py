"""The training step: SGD (momentum, Nesterov, weight decay) with an
atomic NaN skip that stays on the device.

Counterpart of ``synergynet_tpu/train/step.py``. The update follows
optax's chain in ``make_optimizer`` (``step.py:41-51``), leaf for leaf:

1. add the decayed weights, ``g + wd * p``, to every parameter (BatchNorm
   scale and bias included);
2. trace with Nesterov: ``t' = u + m * t``, ``u' = u + m * t'``;
3. scale by ``-lr(count)``, where ``count`` is the optimizer's own count
   of applied updates.

If any gradient is non-finite the whole step is undone with
``torch.where``: parameters, BatchNorm running statistics, the momentum
trace and ``count`` keep their old values, while ``state.step`` still
advances, as in the JAX step (``step.py:190-213``). Nothing on that path
reads a value on the host: ``metrics["skipped"]`` is a device tensor. So
the update is written as tensor ops, not ``torch.optim.SGD``, whose step
cannot be undone without a host branch.

The state keeps every parameter, its gradient, the trace and every
BatchNorm statistic as views into four flat fp32 buffers, so the update
and the skip are a dozen whole-buffer ops whatever the number of leaves,
and autograd accumulates gradients straight into the flat buffer.

:func:`jit_train_step` is the same step on one rank of a
``(data, model)`` mesh (:mod:`synergynet_tpu_torch.core.mesh`): each rank
takes its data row's rows of the global batch, BatchNorm normalizes with
the global batch's statistics (or each rank's own, per-replica), the flat
gradient is averaged over the data group with one ``all_reduce``, and the
NaN skip decides on the reduced gradient, so every rank skips together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from synergynet_tpu_torch.core import mesh as meshlib
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.mm3d.assets import ParamPack
from synergynet_tpu_torch.nn.batchnorm import sync_group
from synergynet_tpu_torch.nn.synergy import (LOSS_WEIGHTS, init_synergy_,
                                             synergy_criterion)


@dataclasses.dataclass
class SGD:
    """The optimizer's hyperparameters: ``lr_fn(count)`` -> lr."""
    lr_fn: Callable
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 0.0


def make_optimizer(lr_fn: Callable, momentum: float = 0.9,
                   nesterov: bool = True, weight_decay: float = 0.0) -> SGD:
    """SGD + momentum + Nesterov with optional decayed weights, the
    reference optimizer (main_train.py:180-184)."""
    return SGD(lr_fn, momentum, nesterov, weight_decay)


def _flatten_into(tensors, attach_grad: bool) -> Tuple[torch.Tensor,
                                                        Optional[torch.Tensor]]:
    """Copy ``tensors`` into one flat buffer and make each a view of it;
    with ``attach_grad`` also give each a ``.grad`` view of a zeroed flat
    gradient buffer."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    grads = torch.zeros_like(flat) if attach_grad else None
    off = 0
    for t in tensors:
        n = t.numel()
        t.data = flat[off:off + n].view_as(t)
        if attach_grad:
            t.grad = grads[off:off + n].view_as(t)
        off += n
    return flat, grads


class TrainState:
    """The model and its optimizer state on the model's device.

    ``step`` (int32) counts every step taken, skipped ones too; ``count``
    (int32) counts applied updates and indexes the learning rate;
    ``trace`` is the momentum, flat, in the order of
    ``model.parameters()``."""

    def __init__(self, model: nn.Module, weight_decay: float = 0.0):
        self.model = model
        self.weight_decay = weight_decay
        self.params, self.grads = _flatten_into(model.parameters(), True)
        self.stats, _ = _flatten_into(model.buffers(), False)
        dev = self.params.device
        self.trace = torch.zeros_like(self.params)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def device(self) -> torch.device:
        return self.params.device

    def tensors(self):
        """Every buffer of the state, for a broadcast
        (:func:`~synergynet_tpu_torch.core.mesh.replicate`)."""
        return [self.params, self.stats, self.trace, self.count, self.step]

    def _trace_views(self) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, p in self.model.named_parameters():
            out[name] = self.trace[off:off + p.numel()].view_as(p)
            off += p.numel()
        return out

    def variables(self) -> dict:
        """``{"params", "batch_stats"}`` as flax-shaped numpy trees."""
        return flax_from_state_dict(self.model.state_dict())

    def tree(self) -> dict:
        """The whole state as the JAX ``TrainState``'s leaves: ``step``,
        ``params``, ``batch_stats`` and ``opt_state`` (the trace and the
        count, at optax's chain indices), numpy."""
        variables = self.variables()
        i = 1 if self.weight_decay else 0     # add_decayed_weights' slot
        return {
            "step": np.asarray(self.step.cpu(), np.int32),
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {
                str(i): {"trace": flax_from_state_dict(
                    self._trace_views())["params"]},
                str(i + 1): {"count": np.asarray(self.count.cpu(),
                                                 np.int32)}},
        }

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Load a :meth:`tree`-shaped dict (a checkpoint) in place."""
        self.model.load_state_dict(state_dict_from_flax(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]}))
        i = 1 if self.weight_decay else 0
        trace = state_dict_from_flax(
            {"params": tree["opt_state"][str(i)]["trace"]})
        for name, view in self._trace_views().items():
            view.copy_(trace[name])
        self.count.fill_(int(tree["opt_state"][str(i + 1)]["count"]))
        self.step.fill_(int(tree["step"]))


def create_train_state(model: nn.Module, generator: torch.Generator,
                       optimizer: SGD) -> TrainState:
    """Draw ``model``'s weights as flax initializes them (from
    ``generator``, on the model's device) and wrap it in a fresh state."""
    init_synergy_(model, generator)
    return TrainState(model, optimizer.weight_decay)


def make_train_step(pack: ParamPack, optimizer: SGD, bn_groups: int = 1,
                    accum_steps: int = 1, device="cuda",
                    augment: Optional[Callable] = None) -> Callable:
    """Returns ``step(state, images, target62, generator=None,
    augment_seed=None) -> (state, metrics)`` on ``device`` (the card unless
    the caller asks for the CPU; raises without a card). The state is
    updated in place.

    ``images``: (B, 120, 120, 3) uint8, normalized here as
    ``(x - 127.5) / 128``, or float, taken as normalized. ``generator``
    draws the head's dropout masks. ``augment``: the device-side
    augmentation ``(images_u8, seed) -> float in [0, 255]``
    (:func:`synergynet_tpu_torch.data.device_augment.device_augment`),
    applied to the uint8 batch before the normalization with the step's
    ``augment_seed``, which the caller draws apart from the dropout seed
    (the JAX step folds 7 into the step's key). ``metrics``: the five
    weighted terms, ``loss_total`` and ``skipped`` (1.0 when the step was
    undone), all device tensors. ``accum_steps`` > 1 runs the batch as that
    many microbatches in sequence, BatchNorm statistics chaining through
    them, and steps on the mean of their gradients.

    ``bn_groups`` > 1: per-replica BatchNorm in one process, as the JAX
    step's ``bn_groups`` (``step.py:158-183``) and the reference's
    ``nn.DataParallel``: the batch splits into that many contiguous groups,
    each normalized with its own statistics; the loss is the mean of the
    group means; group 0's running statistics persist (DataParallel
    broadcasts the master replica's buffers). A batch that does not divide
    raises ``ValueError``, and so does ``accum_steps`` > 1 with it."""
    return _make_step(pack, optimizer, bn_groups, accum_steps, device,
                      augment, None)


def jit_train_step(pack: ParamPack, optimizer: SGD, mesh,
                   augment: Optional[Callable] = None, bn_groups: int = 1,
                   accum_steps: int = 1, device=None) -> Callable:
    """The train step on this rank of ``mesh``: the same ``step(state,
    images, target62, generator=None, augment_seed=None)``, called with
    the rank's own rows of the global batch (its data row's block) on
    every rank of the mesh.

    - ``bn_groups`` 1: BatchNorm normalizes with the global batch's
      statistics, synchronized over the data group (the JAX default,
      ``per_replica_bn=False``). A multiple of the data size: each rank
      normalizes its own rows, in ``bn_groups / n_data`` groups, and data
      row 0's running statistics are broadcast over the data group, as
      ``nn.DataParallel`` and the JAX docstring (``step.py:79-89``) say.
    - The flat gradient is averaged over the data group (one
      ``all_reduce``); so are the loss metrics, which then describe the
      global batch.
    - The NaN skip decides on the reduced gradient: every rank skips
      together. Model columns see the same rows and hold the same state.

    ``device`` defaults to the mesh's. Outside a process group (a 1x1
    mesh) this is :func:`make_train_step`, bit for bit. Under the mesh,
    ``accum_steps`` microbatch ``i`` is every rank's ``i``-th slice of its
    rows."""
    return _make_step(pack, optimizer, bn_groups, accum_steps,
                      mesh.device if device is None else device, augment,
                      mesh)


def _make_step(pack, optimizer, bn_groups, accum_steps, device, augment,
               mesh):
    if accum_steps > 1 and bn_groups > 1:
        raise ValueError("accum_steps and bn_groups are mutually exclusive")
    dev = resolve_device(device)
    n_data = mesh.shape[meshlib.DATA_AXIS] if mesh is not None else 1
    data_group = mesh.data_group if mesh is not None else None
    if bn_groups == 1:
        # One data row has nothing to synchronize: its batch is global.
        local_groups = 1
        bn_group = data_group if n_data > 1 else None
    elif bn_groups % n_data == 0:
        local_groups, bn_group = bn_groups // n_data, None
    else:
        raise ValueError(f"bn_groups={bn_groups} must be 1 or a multiple of "
                         f"the mesh's data size ({n_data})")
    # The criterion decodes landmarks only: leave the dense basis behind.
    pack_dev = pack._replace(u=pack.u[:0], w_shp=pack.w_shp[:0],
                             w_exp=pack.w_exp[:0]).to(dev)
    wd, mom = optimizer.weight_decay, optimizer.momentum
    parts = max(accum_steps, local_groups)
    what = "BN groups" if local_groups > 1 else "microbatches"

    def criterion(state, images, target62, generator):
        total, losses = synergy_criterion(state.model, images, target62,
                                          pack_dev, generator)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    def reduce_over_data(state, total, losses):
        """Average the gradient and the metrics over the data group; with
        per-replica statistics, take data row 0's."""
        dist.all_reduce(state.grads, group=data_group)
        state.grads.div_(n_data)
        keys = sorted(losses)
        vec = torch.stack([total] + [losses[k] for k in keys])
        dist.all_reduce(vec, group=data_group)
        vec = vec / n_data
        if bn_groups > 1:
            dist.broadcast(state.stats, src=mesh.data_ranks()[0],
                           group=data_group)
        return vec[0], dict(zip(keys, vec[1:]))

    def train_step(state: TrainState, images: torch.Tensor,
                   target62: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   augment_seed: Optional[int] = None):
        if state.device != dev:
            raise ValueError(f"state on {state.device}, step on {dev}")
        state.model.train()
        images = images.to(dev, non_blocking=True)
        target62 = target62.to(dev, non_blocking=True)
        if augment is not None:
            if augment_seed is None:
                raise ValueError("a step built with augment= needs its "
                                 "augment_seed")
            images = (augment(images, augment_seed) - 127.5) / 128.0
        elif images.dtype == torch.uint8:
            images = (images.float() - 127.5) / 128.0
        b = images.shape[0]
        if b % parts:
            raise ValueError(f"batch {b} not divisible into {parts} {what}")
        stats_before = state.stats.clone()
        state.grads.zero_()
        with sync_group(state.model, bn_group):
            if parts == 1:
                total, losses = criterion(state, images, target62,
                                          generator)
            else:
                mb = b // parts
                total = torch.zeros((), device=dev)
                losses = {k: torch.zeros((), device=dev)
                          for k in LOSS_WEIGHTS}
                for i in range(parts):
                    sl = slice(i * mb, (i + 1) * mb)
                    t_, l_ = criterion(state, images[sl], target62[sl],
                                       generator)
                    if i == 0 and local_groups > 1:
                        stats_group0 = state.stats.clone()
                    total = total + t_
                    losses = {k: losses[k] + l_[k] for k in losses}
                inv = 1.0 / parts
                state.grads.mul_(inv)
                total = total * inv
                losses = {k: v * inv for k, v in losses.items()}
                if local_groups > 1:
                    state.stats.copy_(stats_group0)
        if data_group is not None:
            total, losses = reduce_over_data(state, total, losses)

        with torch.no_grad():
            g, p, t = state.grads, state.params, state.trace
            ok = torch.isfinite(g).all()
            u = g + wd * p if wd else g
            new_t = u + mom * t
            u = u + mom * new_t if optimizer.nesterov else new_t
            new_p = p + (-optimizer.lr_fn(state.count)) * u
            p.copy_(torch.where(ok, new_p, p))
            t.copy_(torch.where(ok, new_t, t))
            state.stats.copy_(torch.where(ok, state.stats, stats_before))
            state.count.copy_(torch.where(ok, state.count + 1, state.count))
            state.step.add_(1)
        metrics = {**losses, "loss_total": total,
                   "skipped": (~ok).float()}
        return state, metrics

    return train_step
