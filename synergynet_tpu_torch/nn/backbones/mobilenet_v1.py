"""MobileNetV1 backbone with the 3DMM parameter head.

Counterpart of ``synergynet_tpu/nn/backbones/mobilenet_v1.py``: a 3x3/2
conv, then 13 depthwise-separable pairs (depthwise 3x3 + BN + ReLU,
pointwise 1x1 + BN + ReLU) to 1024 channels, scaled by ``widen_factor``
(``max(8, int(c * w))`` channels), global average pool and the shared
head, returning ``(param62, pooled_feature)``. Submodules carry the flax
auto-names: the stem is ``_ConvBN_0``, pair k is ``_ConvBN_{1+2k}``
(depthwise) and ``_ConvBN_{2+2k}`` (pointwise), each holding ``Conv_0``
and ``BatchNorm_0``; the head is ``ParamHead_0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw

# (out_channels, stride) of each depthwise-separable pair at width 1.0.
_DS_SCHEDULE = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
                (1024, 1))


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                             groups=groups)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class MobileNetV1(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> ``(param62 (B, 62) fp32,
    pooled feature (B, C) fp32)``."""

    def __init__(self, widen_factor: float = 1.0, dropout: float = 0.2,
                 with_texture: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.with_texture = with_texture
        ch = lambda c: max(8, int(c * widen_factor))    # noqa: E731
        layers = [_ConvBN(3, ch(32), stride=2)]
        cin = ch(32)
        for c, s in _DS_SCHEDULE:
            layers.append(_ConvBN(cin, cin, 3, s, groups=cin))   # depthwise
            layers.append(_ConvBN(cin, ch(c), 1))
            cin = ch(c)
        for i, layer in enumerate(layers):
            self.add_module(f"_ConvBN_{i}", layer)
        self._n_layers = len(layers)
        self.ParamHead_0 = ParamHead(cin, dropout=dropout,
                                     with_texture=with_texture)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = to_nchw(x, self.dtype)
        for i in range(self._n_layers):
            x = getattr(self, f"_ConvBN_{i}")(x)
        feat = spatial_mean(x).float()
        param = self.ParamHead_0(feat, generator)
        return (param[:, :62] if self.with_texture else param), feat
