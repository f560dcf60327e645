"""Learning-rate schedule: the reference's step decay.

Counterpart of ``synergynet_tpu/train/schedule.py`` (reference
main_train.py:74-94): the factor exponent is 1 during the first ``warmup``
epochs (a flat damped phase, lr = base * 0.2), 0 from there to the first
milestone, then i after milestone i. Epochs count from 1. The functions
take Python ints or integer tensors; on a tensor the result is an fp32
tensor on its device, computed there (the train step reads no count on
the host).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def step_decay_lr(base_lr: float = 0.08,
                  milestones: Sequence[int] = (48, 64),
                  warmup: int = 5, gamma: float = 0.2) -> Callable:
    """Returns epoch -> lr."""
    milestones = tuple(int(m) for m in milestones)

    def lr_for_epoch(epoch):
        epoch = torch.as_tensor(epoch)
        n_past = torch.zeros_like(epoch)
        for m in milestones:
            n_past = n_past + (epoch > m).to(epoch.dtype)
        n = torch.where(epoch <= warmup, torch.ones_like(epoch), n_past)
        # fp32 as in the JAX package: f32(gamma) ** n, times f32(base_lr).
        return base_lr * torch.pow(torch.full_like(epoch, gamma,
                                                   dtype=torch.float32),
                                   n.float())

    return lr_for_epoch


def lr_per_step(base_lr: float, milestones: Sequence[int], warmup: int,
                steps_per_epoch: int, gamma: float = 0.2) -> Callable:
    """Step-indexed: epoch = step // steps_per_epoch + 1 (the reference's
    1-based epoch loop, main_train.py:218)."""
    epoch_fn = step_decay_lr(base_lr, milestones, warmup, gamma)

    def lr_for_step(step):
        step = torch.as_tensor(step)
        return epoch_fn(torch.div(step, steps_per_epoch,
                                  rounding_mode="floor") + 1)

    return lr_for_step
