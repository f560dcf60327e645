"""MobileNetV2 1.0 (Sandler et al. 2018, arXiv:1801.04381; the reference's
``backbone_nets/mobilenetv2_backbone.py``) with the 12/40/10 head.

Served from the shipped trained file only: :func:`spec` draws nothing.
"""

from __future__ import annotations

import torch

from perfbench.reference.nets import bn, conv, head
from perfbench.reference.precision import Precision

SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _cbr6(p, node, x, stride=1):
    return torch.clamp(bn(node["BatchNorm_0"],
                          conv(p, node["Conv_0"], x, stride)), 0.0, 6.0)


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, S, S, 3) crops -> (B, 62) parameters."""
    x = _cbr6(p, t["ConvBNReLU6_0"], x_nhwc.permute(0, 3, 1, 2), 2)
    i, cin = 0, 32
    for e, c, n, s in SETTING:
        for r in range(n):
            node = t[f"InvertedResidual_{i}"]
            stride = s if r == 0 else 1
            y, j = x, 0
            if e != 1:
                y, j = _cbr6(p, node["ConvBNReLU6_0"], y), 1
            y = _cbr6(p, node[f"ConvBNReLU6_{j}"], y, stride)
            y = bn(node["BatchNorm_0"], conv(p, node["Conv_0"], y))
            x = x + y if stride == 1 and cin == c else y
            cin, i = c, i + 1
    x = _cbr6(p, t["ConvBNReLU6_1"], x)
    return head(p, t["ParamHead_0"], x.mean(dim=(2, 3)))


def spec():
    return None
