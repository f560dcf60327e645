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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.mm3d.assets import ParamPack
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
                    accum_steps: int = 1, device="cuda") -> Callable:
    """Returns ``step(state, images, target62, generator=None) ->
    (state, metrics)`` on ``device`` (the card unless the caller asks for
    the CPU; raises without a card). The state is updated in place.

    ``images``: (B, 120, 120, 3) uint8, normalized here as
    ``(x - 127.5) / 128``, or float, taken as normalized. ``generator``
    draws the head's dropout masks. ``metrics``: the five weighted terms,
    ``loss_total`` and ``skipped`` (1.0 when the step was undone), all
    device tensors. ``accum_steps`` > 1 runs the batch as that many
    microbatches in sequence, BatchNorm statistics chaining through them,
    and steps on the mean of their gradients."""
    if bn_groups > 1:
        raise NotImplementedError(
            "per-replica BatchNorm groups are not ported yet (ROADMAP.md, "
            "queue A: bn_groups and multi-process training)")
    dev = resolve_device(device)
    # The criterion decodes landmarks only: leave the dense basis behind.
    pack_dev = pack._replace(u=pack.u[:0], w_shp=pack.w_shp[:0],
                             w_exp=pack.w_exp[:0]).to(dev)
    wd, mom = optimizer.weight_decay, optimizer.momentum

    def criterion(state, images, target62, generator):
        total, losses = synergy_criterion(state.model, images, target62,
                                          pack_dev, generator)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    def train_step(state: TrainState, images: torch.Tensor,
                   target62: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        if state.device != dev:
            raise ValueError(f"state on {state.device}, step on {dev}")
        state.model.train()
        images = images.to(dev, non_blocking=True)
        target62 = target62.to(dev, non_blocking=True)
        if images.dtype == torch.uint8:
            images = (images.float() - 127.5) / 128.0
        stats_before = state.stats.clone()
        state.grads.zero_()
        if accum_steps == 1:
            total, losses = criterion(state, images, target62, generator)
        else:
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible into "
                                 f"{accum_steps} microbatches")
            mb = b // accum_steps
            total = torch.zeros((), device=dev)
            losses = {k: torch.zeros((), device=dev) for k in LOSS_WEIGHTS}
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                t_, l_ = criterion(state, images[sl], target62[sl],
                                   generator)
                total = total + t_
                losses = {k: losses[k] + l_[k] for k in losses}
            inv = 1.0 / accum_steps
            state.grads.mul_(inv)
            total = total * inv
            losses = {k: v * inv for k, v in losses.items()}

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
