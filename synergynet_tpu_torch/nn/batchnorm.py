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
"""

from __future__ import annotations

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
        mean = xf.mean(axes)
        mean2 = (xf * xf).mean(axes)
        var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())
        return self._normalize(x, mean, var)

    def _normalize(self, x, mean, var):
        shape = self._shape(x)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)
