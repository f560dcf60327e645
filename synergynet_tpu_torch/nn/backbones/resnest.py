"""ResNeSt backbone with split-attention convolutions and the 3DMM head.

Counterpart of ``synergynet_tpu/nn/backbones/resnest.py``: a deep stem of
three 3x3 convs and a 3x3/2 max-pool, bottlenecks whose 3x3 conv is a
:class:`SplAtConv2d` (a radix-grouped conv whose branches are fused by a
per-channel rSoftMax attention), the ``avd`` average-pool downsampling and
the ``avg_down`` shortcut, global average pool and the shared head;
returns ``(param62, pooled_feature_2048)``. Submodules carry the flax
auto-names (``Conv_0``, ``BatchNorm_0``, ``ResNeStBottleneck_k``,
``SplAtConv2d_0``, ``ParamHead_0``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw


class SplAtConv2d(nn.Module):
    """Split attention: a conv grouped ``groups * radix`` ways into
    ``radix`` branches of ``features`` channels; their sum's global pool
    through two cardinality-grouped biased 1x1 convs (``Conv_1`` to
    ``max(cin * radix // 4, 32)`` channels + BN + ReLU, ``Conv_2`` back to
    ``features * radix``) gives the attention: a softmax over radix under
    the (cardinality, radix, features/cardinality) channel layout of
    ``Conv_2``'s output, or a sigmoid when ``radix`` is 1."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, radix: int = 2,
                 reduction_factor: int = 4):
        super().__init__()
        self.radix, self.features, self.groups = radix, features, groups
        inter = max(cin * radix // reduction_factor, 32)
        self.Conv_0 = Conv2d(cin, features * radix, kernel, stride,
                             (kernel - 1) // 2, groups=groups * radix)
        self.BatchNorm_0 = BatchNorm(features * radix)
        self.Conv_1 = Conv2d(features, inter, 1, groups=groups, bias=True)
        self.BatchNorm_1 = BatchNorm(inter)
        self.Conv_2 = Conv2d(inter, features * radix, 1, groups=groups,
                             bias=True)

    def forward(self, x):
        r, c = self.radix, self.features
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        b, _, h, w = y.shape
        split = y.reshape(b, r, c, h, w)                # radix branches
        gap = spatial_mean(split.sum(1), keepdim=True)  # (B, C, 1, 1)
        gap = F.relu(self.BatchNorm_1(self.Conv_1(gap)))
        atten = self.Conv_2(gap)                        # (B, C*r, 1, 1)
        if r > 1:
            atten = atten.reshape(b, self.groups, r, c // self.groups)
            atten = torch.softmax(atten, dim=2).transpose(1, 2).reshape(
                b, r, c, 1, 1)
            return (split * atten).sum(1)
        return y * torch.sigmoid(atten.reshape(b, c, 1, 1))


class ResNeStBottleneck(nn.Module):
    """``features`` base planes; the output has 4x."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 radix: int = 2, groups: int = 1, bottleneck_width: int = 64,
                 avd: bool = True, avd_first: bool = False,
                 is_first: bool = False):
        super().__init__()
        width = int(features * (bottleneck_width / 64.0)) * groups
        out_ch = features * 4
        self.stride, self.avd_first = stride, avd_first
        self.avd = avd and (stride > 1 or is_first)
        self.Conv_0 = Conv2d(cin, width, 1)
        self.BatchNorm_0 = BatchNorm(width)
        self.SplAtConv2d_0 = SplAtConv2d(width, width,
                                         stride=1 if self.avd else stride,
                                         groups=groups, radix=radix)
        self.Conv_1 = Conv2d(width, out_ch, 1)
        self.BatchNorm_1 = BatchNorm(out_ch)
        self.project = stride != 1 or cin != out_ch
        if self.project:
            self.Conv_2 = Conv2d(cin, out_ch, 1)
            self.BatchNorm_2 = BatchNorm(out_ch)

    def _avd_pool(self, z):
        # The reference's AvgPool2d(3, stride, padding=1), whose default
        # count_include_pad=True divides by 9 at the borders too.
        return F.avg_pool2d(z, 3, self.stride, 1, count_include_pad=True)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        if self.avd and self.avd_first:
            y = self._avd_pool(y)
        y = self.SplAtConv2d_0(y)
        if self.avd and not self.avd_first:
            y = self._avd_pool(y)
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            if self.stride != 1:
                # avg_down: the reference's AvgPool2d(s, s, ceil_mode=True,
                # count_include_pad=False), which the JAX package emulates
                # with right/bottom padding left out of the average.
                x = F.avg_pool2d(x, self.stride, self.stride, ceil_mode=True,
                                 count_include_pad=False)
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(x + y)


class ResNeSt(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> ``(param62 (B, 62) fp32,
    pooled feature (B, 2048) fp32)``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), radix: int = 2,
                 groups: int = 1, bottleneck_width: int = 64,
                 stem_width: int = 32, avd_first: bool = False,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        # deep stem: 3x3/2 -> 3x3 -> 3x3
        for i, (c, s) in enumerate(((stem_width, 2), (stem_width, 1),
                                    (stem_width * 2, 1))):
            self.add_module(f"Conv_{i}", Conv2d(cin, c, 3, s, 1))
            self.add_module(f"BatchNorm_{i}", BatchNorm(c))
            cin = c
        blocks = []
        for stage, n in enumerate(layers):
            planes = 64 * (2 ** stage)
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                # is_first stays False, as in the reference's layers: avd is
                # active exactly where stride > 1.
                blocks.append(ResNeStBottleneck(
                    cin, planes, stride, radix, groups, bottleneck_width,
                    avd_first=avd_first))
                cin = planes * 4
        self._n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"ResNeStBottleneck_{i}", blk)
        self.ParamHead_0 = ParamHead(cin, dropout=dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = to_nchw(x, self.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Conv_{i}")(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self._n_blocks):
            x = getattr(self, f"ResNeStBottleneck_{i}")(x)
        feat = spatial_mean(x).float()
        return self.ParamHead_0(feat, generator), feat


# name -> (layers, stem_width)
RESNEST_LAYERS = {
    "resnest50": ((3, 4, 6, 3), 32),
    "resnest101": ((3, 4, 23, 3), 64),
    "resnest200": ((3, 24, 36, 3), 64),
    "resnest269": ((3, 30, 48, 8), 64),
}

# The _fast ablations: (radix, groups, bottleneck_width, avd_first) on the
# resnest50 layer schedule.
RESNEST_FAST_VARIANTS = {
    "resnest50_fast_1s1x64d": (1, 1, 64, True),
    "resnest50_fast_2s1x64d": (2, 1, 64, True),
    "resnest50_fast_4s1x64d": (4, 1, 64, True),
    "resnest50_fast_1s2x40d": (1, 2, 40, True),
    "resnest50_fast_2s2x40d": (2, 2, 40, True),
    "resnest50_fast_1s4x24d": (1, 4, 24, True),
}


def make_resnest(name: str, **kwargs) -> ResNeSt:
    if name in RESNEST_FAST_VARIANTS:
        radix, groups, bw, avd_first = RESNEST_FAST_VARIANTS[name]
        return ResNeSt(layers=(3, 4, 6, 3), stem_width=32, radix=radix,
                       groups=groups, bottleneck_width=bw,
                       avd_first=avd_first, **kwargs)
    layers, stem = RESNEST_LAYERS[name]
    return ResNeSt(layers=layers, stem_width=stem, **kwargs)
