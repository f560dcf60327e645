"""BatchNorm as flax computes it, in eval and in train mode.

Counterpart of ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` as the
JAX package uses it (``normalization._compute_stats`` and ``_normalize``,
flax 0.12.3):

- train mode normalizes with the batch's statistics, reduced in fp32 even
  for bf16 inputs: the mean and the "fast" variance E[x^2] - E[x]^2,
  clipped at 0;
- it then moves the running statistics to ``0.9 * old + 0.1 * batch``,
  the running variance taking the biased batch variance.
  ``F.batch_norm(training=True)`` would store the unbiased variance, so it
  never sees the running buffers;
- the output is ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
  fp32, rounded once to the input's dtype.

``scale`` and ``bias`` are parameters (``weight``, ``bias``); the running
statistics are buffers (``running_mean``, ``running_var``).

Synchronized over a data group (:func:`sync_group`), train mode
normalizes with the statistics of the whole global batch, as the JAX
package does under a mesh (``Config.train.per_replica_bn=False``): each
rank sums its rows' x and x^2 in fp32 with its row count, one
``all_reduce`` adds them over the group, and the same fast variance and
running update follow. The collective is
``torch.distributed.nn.functional.all_reduce``, so the gradient flows back
through it. With no group the module computes as before, bit for bit.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9
EPSILON = 1e-5


class BatchNorm(nn.Module):
    """``channel_dim`` 1 for NCHW activations (the backbone), -1 for
    (B, N, C) point features (the synergy MLPs)."""

    def __init__(self, features: int, channel_dim: int = 1,
                 eps: float = EPSILON, momentum: float = MOMENTUM):
        super().__init__()
        self.channel_dim = channel_dim
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None       # a process group: synchronized statistics

    def _shape(self, x: torch.Tensor):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        return shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.channel_dim == 1:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            return self._normalize(x, self.running_mean, self.running_var)
        cd = self.channel_dim % x.dim()
        axes = [d for d in range(x.dim()) if d != cd]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.group is None:
            mean = xf.mean(axes)
            mean2 = (xf * xf).mean(axes)
        else:
            mean, mean2 = self._global_moments(xf, axes)
        var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())
        return self._normalize(x, mean, var)

    def _global_moments(self, xf, axes):
        from torch.distributed.nn.functional import all_reduce
        c = xf.shape[self.channel_dim]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype,
                           device=xf.device)
        sums = all_reduce(torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                                     count]), group=self.group)
        return sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]

    def _normalize(self, x, mean, var):
        shape = self._shape(x)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


@contextlib.contextmanager
def sync_group(model: nn.Module, group):
    """Within the block, every :class:`BatchNorm` of ``model`` synchronizes
    its train-mode statistics over ``group`` (None: each on its own)."""
    mods = [m for m in model.modules() if isinstance(m, BatchNorm)]
    old = [m.group for m in mods]
    for m in mods:
        m.group = group
    try:
        yield
    finally:
        for m, g in zip(mods, old):
            m.group = g
