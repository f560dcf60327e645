"""ResNeSt-50 (Zhang et al. 2020, arXiv:2004.08955; the reference's
``backbone_nets/ResNeSt/resnest.py``) with the 12/40/10 head: deep stem of
width 32, radix 2, cardinality 1, bottleneck width 64, ``avg_down``,
``avd`` after the split attention."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.nets import (Spec, _bn_leaves, _conv_leaf,
                                      _head_spec, bn, conv, head,
                                      synergy_mlp_spec)
from perfbench.reference.precision import Precision

LAYERS = (3, 4, 6, 3)
RADIX = 2
STEM_WIDTH = 32


def _splat(p, node, x):
    y = F.relu(bn(node["BatchNorm_0"], conv(p, node["Conv_0"], x)))
    b, ch, h, w = y.shape
    split = y.reshape(b, RADIX, ch // RADIX, h, w)
    gap = split.sum(1).mean(dim=(2, 3), keepdim=True)
    gap = F.relu(bn(node["BatchNorm_1"], conv(p, node["Conv_1"], gap)))
    att = conv(p, node["Conv_2"], gap).reshape(b, 1, RADIX, ch // RADIX)
    att = torch.softmax(att, dim=2).transpose(1, 2).reshape(
        b, RADIX, ch // RADIX, 1, 1)
    return (split * att).sum(1)


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, S, S, 3) crops -> (B, 62) parameters."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for i in range(3):
        x = F.relu(bn(t[f"BatchNorm_{i}"],
                      conv(p, t[f"Conv_{i}"], x, 2 if i == 0 else 1)))
    x = F.max_pool2d(x, 3, 2, 1)
    k, cin = 0, 2 * STEM_WIDTH
    for stage, n in enumerate(LAYERS):
        planes = 64 * 2 ** stage
        for i in range(n):
            node = t[f"ResNeStBottleneck_{k}"]
            stride = 2 if stage > 0 and i == 0 else 1
            y = F.relu(bn(node["BatchNorm_0"], conv(p, node["Conv_0"], x)))
            y = _splat(p, node["SplAtConv2d_0"], y)
            if stride > 1:
                y = F.avg_pool2d(y, 3, stride, 1, count_include_pad=True)
            y = bn(node["BatchNorm_1"], conv(p, node["Conv_1"], y))
            if stride != 1 or cin != 4 * planes:
                if stride != 1:
                    x = F.avg_pool2d(x, stride, stride, ceil_mode=True,
                                     count_include_pad=False)
                x = bn(node["BatchNorm_2"], conv(p, node["Conv_2"], x))
            x = F.relu(x + y)
            cin, k = 4 * planes, k + 1
    return head(p, t["ParamHead_0"], x.mean(dim=(2, 3)))


def spec() -> Spec:
    out: Spec = []
    root = ("backbone",)
    cin = 3
    for i, c in enumerate((STEM_WIDTH, STEM_WIDTH, 2 * STEM_WIDTH)):
        _conv_leaf(out, root + (f"Conv_{i}",), 3, cin, c)
        _bn_leaves(out, root + (f"BatchNorm_{i}",), c)
        cin = c
    k = 0
    for stage, n in enumerate(LAYERS):
        planes = 64 * 2 ** stage
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            b = root + (f"ResNeStBottleneck_{k}",)
            s = b + ("SplAtConv2d_0",)
            inter = max(planes * RADIX // 4, 32)
            _conv_leaf(out, b + ("Conv_0",), 1, cin, planes)
            _bn_leaves(out, b + ("BatchNorm_0",), planes)
            _conv_leaf(out, s + ("Conv_0",), 3, planes // RADIX,
                       planes * RADIX)
            _bn_leaves(out, s + ("BatchNorm_0",), planes * RADIX)
            _conv_leaf(out, s + ("Conv_1",), 1, planes, inter, bias=True)
            _bn_leaves(out, s + ("BatchNorm_1",), inter)
            _conv_leaf(out, s + ("Conv_2",), 1, inter, planes * RADIX,
                       bias=True)
            _conv_leaf(out, b + ("Conv_1",), 1, planes, 4 * planes)
            _bn_leaves(out, b + ("BatchNorm_1",), 4 * planes,
                       "bn_scale_residual")
            if stride != 1 or cin != 4 * planes:
                _conv_leaf(out, b + ("Conv_2",), 1, cin, 4 * planes)
                _bn_leaves(out, b + ("BatchNorm_2",), 4 * planes)
            cin, k = 4 * planes, k + 1
    _head_spec(out, root + ("ParamHead_0",), cin)
    return out + synergy_mlp_spec(cin)
