"""MobileNetV2 backbone with the 12/40/10 3DMM parameter head.

Counterpart of ``synergynet_tpu/nn/backbones/mobilenet_v2.py``: the
standard MobileNetV2 trunk, global average pool, and the 62-d head; returns
``(param62, pooled_feature)``. Submodule names follow the flax auto-names
(``ConvBNReLU6_0``, ``InvertedResidual_3``, ``Conv_0``, ``BatchNorm_0``,
``ParamHead_0``), so :mod:`synergynet_tpu_torch.convert` maps a flax tree
by path.

Numerics follow flax in the compute dtype (:mod:`~synergynet_tpu_torch.nn.
layers`): convolutions and activations run in ``dtype`` (bf16 for serving and training) while the parameters,
the BatchNorm statistics and the head stay fp32. Flax evaluates BatchNorm
in fp32 and rounds once to the module dtype; ``F.batch_norm`` on a bf16
input with fp32 statistics does the same in eval, and
:class:`~synergynet_tpu_torch.nn.batchnorm.BatchNorm` follows flax's train
mode. ``module.train()`` selects train mode, as for any torch module.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw

# (expand_ratio t, out_channels c, repeats n, stride s)
_DEFAULT_SETTING: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Round channel counts to a multiple of ``divisor`` (never below 90%)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``minimum(relu(x), 6)`` as the JAX package writes it: at exactly 6
    the gradient splits half and half like ``jnp.minimum``'s, where
    ``F.relu6`` (hardtanh) passes none; 6.0 is common in bf16."""
    return torch.minimum(F.relu(x), torch.tensor(6.0, dtype=x.dtype))


class ConvBNReLU6(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                             groups=groups)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return relu6(self.BatchNorm_0(self.Conv_0(x)))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(cin, hidden, kernel=1))
        layers.append(ConvBNReLU6(hidden, hidden, kernel=3, stride=stride,
                                  groups=hidden))
        for i, layer in enumerate(layers):      # flax auto-names, in order
            self.add_module(f"ConvBNReLU6_{i}", layer)
        self._n_cbr = len(layers)
        self.Conv_0 = Conv2d(hidden, cout, 1)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        y = x
        for i in range(self._n_cbr):
            y = getattr(self, f"ConvBNReLU6_{i}")(y)
        y = self.BatchNorm_0(self.Conv_0(y))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> ``(param62 (B, 62) fp32,
    pooled feature (B, 1280) fp32)``. In train mode the head's dropout
    (rate ``dropout``) draws from the ``generator`` passed to ``forward``."""

    def __init__(self, width_mult: float = 1.0,
                 setting: Sequence[Tuple[int, int, int, int]] = _DEFAULT_SETTING,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        input_channel = make_divisible(32 * width_mult)
        last_channel = make_divisible(1280 * max(1.0, width_mult))
        self.ConvBNReLU6_0 = ConvBNReLU6(3, input_channel, stride=2)
        blocks = []
        cin = input_channel
        for t, c, n, s in setting:
            out_c = make_divisible(c * width_mult)
            for i in range(n):
                blocks.append(InvertedResidual(cin, out_c, s if i == 0 else 1,
                                               t))
                cin = out_c
        for i, blk in enumerate(blocks):
            self.add_module(f"InvertedResidual_{i}", blk)
        self._n_blocks = len(blocks)
        self.ConvBNReLU6_1 = ConvBNReLU6(cin, last_channel, kernel=1)
        self.ParamHead_0 = ParamHead(last_channel, dropout=dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.ConvBNReLU6_0(to_nchw(x, self.dtype))
        for i in range(self._n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = self.ConvBNReLU6_1(x)
        pool = spatial_mean(x).float()
        return self.ParamHead_0(pool, generator), pool
