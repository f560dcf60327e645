"""ResNet, ResNeXt and wide-ResNet backbones with the 3DMM parameter head.

Counterpart of ``synergynet_tpu/nn/backbones/resnet.py``: a 7x7/2 conv +
BN + ReLU and a 3x3/2 max-pool, four stages of ``BasicBlock`` (18, 34) or
``Bottleneck`` (with ``groups`` and ``width_per_group``) with a 1x1
projection shortcut where the shape changes, global average pool and the
shared head, returning ``(param62, pooled_feature)``. Submodules carry the
flax auto-names (``Conv_0``, ``BatchNorm_0``, ``BasicBlock_k`` /
``Bottleneck_k``, ``ParamHead_0``). The last BatchNorm of each block
starts at scale 0, as flax's ``scale_init=zeros`` there (``zero_init``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw


def zero_init_bn(features: int) -> BatchNorm:
    """A BatchNorm whose scale the seeded init draws as 0."""
    bn = BatchNorm(features)
    bn.zero_init = True
    return bn


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 3, stride, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 3, 1, 1)
        self.BatchNorm_1 = zero_init_bn(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = Conv2d(cin, features, 1, stride)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """``features`` base planes; the output has 4x."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        width = int(features * (width_per_group / 64.0)) * groups
        out_ch = features * 4
        self.Conv_0 = Conv2d(cin, width, 1)
        self.BatchNorm_0 = BatchNorm(width)
        self.Conv_1 = Conv2d(width, width, 3, stride, 1, groups=groups)
        self.BatchNorm_1 = BatchNorm(width)
        self.Conv_2 = Conv2d(width, out_ch, 1)
        self.BatchNorm_2 = zero_init_bn(out_ch)
        self.project = stride != 1 or cin != out_ch
        if self.project:
            self.Conv_3 = Conv2d(cin, out_ch, 1, stride)
            self.BatchNorm_3 = BatchNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> ``(param62 (B, 62) fp32,
    pooled feature (B, C) fp32)``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 block: str = "bottleneck", groups: int = 1,
                 width_per_group: int = 64, dropout: float = 0.2,
                 with_texture: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.with_texture = with_texture
        self.Conv_0 = Conv2d(3, 64, 7, 2, 3)
        self.BatchNorm_0 = BatchNorm(64)
        blocks, cin = [], 64
        for stage, n in enumerate(layers):
            planes = 64 * (2 ** stage)
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                if block == "basic":
                    blocks.append(BasicBlock(cin, planes, stride))
                    cin = planes
                else:
                    blocks.append(Bottleneck(cin, planes, stride, groups,
                                             width_per_group))
                    cin = planes * 4
        name = "BasicBlock" if block == "basic" else "Bottleneck"
        self.block_names = tuple(f"{name}_{i}" for i in range(len(blocks)))
        for n_, blk in zip(self.block_names, blocks):
            self.add_module(n_, blk)
        self.ParamHead_0 = ParamHead(cin, dropout=dropout,
                                     with_texture=with_texture)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.BatchNorm_0(self.Conv_0(to_nchw(x, self.dtype))))
        # flax's max_pool pads with -inf, as F.max_pool2d does.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        feat = spatial_mean(x).float()
        param = self.ParamHead_0(feat, generator)
        return (param[:, :62] if self.with_texture else param), feat


# name -> (layers, block, groups, width_per_group)
RESNET_LAYERS = {
    "resnet18": ((2, 2, 2, 2), "basic", 1, 64),
    "resnet34": ((3, 4, 6, 3), "basic", 1, 64),
    "resnet50": ((3, 4, 6, 3), "bottleneck", 1, 64),
    "resnet101": ((3, 4, 23, 3), "bottleneck", 1, 64),
    "resnet152": ((3, 8, 36, 3), "bottleneck", 1, 64),
    "resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", 32, 4),
    "resnext101_32x8d": ((3, 4, 23, 3), "bottleneck", 32, 8),
    "wide_resnet50_2": ((3, 4, 6, 3), "bottleneck", 1, 128),
    "wide_resnet101_2": ((3, 4, 23, 3), "bottleneck", 1, 128),
}


def make_resnet(name: str, **kwargs) -> ResNet:
    layers, block, groups, wpg = RESNET_LAYERS[name]
    return ResNet(layers=layers, block=block, groups=groups,
                  width_per_group=wpg, **kwargs)
