"""GhostNet backbone with the 3DMM parameter head.

Counterpart of ``synergynet_tpu/nn/backbones/ghostnet.py``: a 3x3/2 stem,
16 ``GhostBottleneck``s (ghost modules, a depthwise stride conv, optional
squeeze-excite with a hard-sigmoid gate), a 1x1 conv to 960 channels,
global average pool, a biased 1x1 conv to 1280 + ReLU, and the shared
head; returns ``(param62, pooled_feature_1280)``. Submodules carry the
flax auto-names (``Conv_0``, ``BatchNorm_0``, ``GhostBottleneck_k``,
``GhostModule_0/1``, ``SqueezeExcite_0``, ``ParamHead_0``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import \
    make_divisible as _make_divisible
from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw

# (kernel, expansion, out_channels, se_ratio, stride): the standard
# width-1.0 schedule.
GHOSTNET_CFG: Tuple[Tuple[int, int, int, float, int], ...] = (
    (3, 16, 16, 0.0, 1),
    (3, 48, 24, 0.0, 2),
    (3, 72, 24, 0.0, 1),
    (5, 72, 40, 0.25, 2),
    (5, 120, 40, 0.25, 1),
    (3, 240, 80, 0.0, 2),
    (3, 200, 80, 0.0, 1),
    (3, 184, 80, 0.0, 1),
    (3, 184, 80, 0.0, 1),
    (3, 480, 112, 0.25, 1),
    (3, 672, 112, 0.25, 1),
    (5, 672, 160, 0.25, 2),
    (5, 960, 160, 0.0, 1),
    (5, 960, 160, 0.25, 1),
    (5, 960, 160, 0.0, 1),
    (5, 960, 160, 0.25, 1),
)


def make_divisible(v) -> int:
    """GhostNet rounds channel counts to multiples of 4."""
    return _make_divisible(v, 4)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


class SqueezeExcite(nn.Module):
    """Pool -> biased 1x1 conv + ReLU -> biased 1x1 conv -> hard-sigmoid
    gate on the channels."""

    def __init__(self, c: int, se_ratio: float = 0.25):
        super().__init__()
        reduced = make_divisible(c * se_ratio)
        self.Conv_0 = Conv2d(c, reduced, 1, bias=True)
        self.Conv_1 = Conv2d(reduced, c, 1, bias=True)

    def forward(self, x):
        s = F.relu(self.Conv_0(spatial_mean(x, keepdim=True)))
        return x * hard_sigmoid(self.Conv_1(s))


class GhostModule(nn.Module):
    """A primary conv makes ``ceil(features / ratio)`` channels, a cheap
    depthwise conv the rest; the concat is sliced to ``features``."""

    def __init__(self, cin: int, features: int, kernel: int = 1,
                 ratio: int = 2, dw_size: int = 3, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.features = features
        self.relu = relu
        init_ch = math.ceil(features / ratio)
        self.Conv_0 = Conv2d(cin, init_ch, kernel, stride, kernel // 2)
        self.BatchNorm_0 = BatchNorm(init_ch)
        self.Conv_1 = Conv2d(init_ch, init_ch * (ratio - 1), dw_size, 1,
                             dw_size // 2, groups=init_ch)
        self.BatchNorm_1 = BatchNorm(init_ch * (ratio - 1))

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x))
        if self.relu:
            y = F.relu(y)
        cheap = self.BatchNorm_1(self.Conv_1(y))
        if self.relu:
            cheap = F.relu(cheap)
        return torch.cat([y, cheap], dim=1)[:, :self.features]


class GhostBottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, dw_kernel: int = 3,
                 stride: int = 1, se_ratio: float = 0.0):
        super().__init__()
        self.stride, self.se = stride, se_ratio > 0
        self.GhostModule_0 = GhostModule(cin, mid, relu=True)
        pad = (dw_kernel - 1) // 2
        convs = []
        if stride > 1:
            convs.append(Conv2d(mid, mid, dw_kernel, stride, pad,
                                groups=mid))
        if self.se:
            self.SqueezeExcite_0 = SqueezeExcite(mid, se_ratio)
        self.GhostModule_1 = GhostModule(mid, out, relu=False)
        self.identity = cin == out and stride == 1
        if not self.identity:
            convs.append(Conv2d(cin, cin, dw_kernel, stride, pad, groups=cin))
            convs.append(Conv2d(cin, out, 1))
        # flax numbers the block's own convs and BatchNorms in creation
        # order: the depthwise stride conv first, then the shortcut's two.
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", BatchNorm(conv.out_channels))

    def _conv_bn(self, i, x):
        return getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x))

    def forward(self, x):
        y = self.GhostModule_0(x)
        i = 0
        if self.stride > 1:
            y = self._conv_bn(0, y)
            i = 1
        if self.se:
            y = self.SqueezeExcite_0(y)
        y = self.GhostModule_1(y)
        short = x if self.identity else self._conv_bn(
            i + 1, self._conv_bn(i, x))
        return y + short


class GhostNet(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> ``(param62 (B, 62) fp32,
    pooled feature (B, 1280) fp32)``."""

    def __init__(self, cfg: Sequence = GHOSTNET_CFG, width: float = 1.0,
                 dropout: float = 0.2, with_texture: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.with_texture = with_texture
        stem = make_divisible(16 * width)
        self.Conv_0 = Conv2d(3, stem, 3, 2, 1)
        self.BatchNorm_0 = BatchNorm(stem)
        cin = stem
        self._n_blocks = len(cfg)
        for i, (k, exp, c, se, s) in enumerate(cfg):
            out = make_divisible(c * width)
            self.add_module(f"GhostBottleneck_{i}", GhostBottleneck(
                cin, make_divisible(exp * width), out, k, s, se))
            cin = out
        final = make_divisible(cfg[-1][1] * width)       # 960 at width 1.0
        self.Conv_1 = Conv2d(cin, final, 1)
        self.BatchNorm_1 = BatchNorm(final)
        self.Conv_2 = Conv2d(final, 1280, 1, bias=True)
        self.ParamHead_0 = ParamHead(1280, dropout=dropout,
                                     with_texture=with_texture)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.BatchNorm_0(self.Conv_0(to_nchw(x, self.dtype))))
        for i in range(self._n_blocks):
            x = getattr(self, f"GhostBottleneck_{i}")(x)
        x = F.relu(self.BatchNorm_1(self.Conv_1(x)))
        x = self.Conv_2(spatial_mean(x, keepdim=True))  # (B, 1280, 1, 1)
        feat = F.relu(x)[:, :, 0, 0].float()
        param = self.ParamHead_0(feat, generator)
        return (param[:, :62] if self.with_texture else param), feat
