"""MobileNetV1 1.0 (Howard et al. 2017, arXiv:1704.04861) with the
12/40/10 head: a 3x3/2 convolution, then 13 depthwise-separable pairs to
1,024 channels, each convolution followed by BatchNorm and ReLU, then the
global mean. The flax names of the port's ``mobilenet_1``: the stem is
``_ConvBN_0``, pair k is ``_ConvBN_{1+2k}`` (depthwise) and
``_ConvBN_{2+2k}`` (pointwise), each holding ``Conv_0`` and
``BatchNorm_0``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.nets import (Spec, _bn_leaves, _conv_leaf,
                                      _head_spec, bn, conv, head,
                                      synergy_mlp_spec)
from perfbench.reference.precision import Precision

# (out_channels, stride) of each depthwise-separable pair.
PAIRS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
         (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
         (1024, 1))


def _layers():
    """(kernel, cin, cout, stride, depthwise) of every convolution."""
    out, cin = [(3, 3, 32, 2, False)], 32
    for c, s in PAIRS:
        out += [(3, cin, cin, s, True), (1, cin, c, 1, False)]
        cin = c
    return out


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, S, S, 3) crops -> (B, 62) parameters."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for i, (_, _, _, stride, _) in enumerate(_layers()):
        node = t[f"_ConvBN_{i}"]
        x = F.relu(bn(node["BatchNorm_0"],
                      conv(p, node["Conv_0"], x, stride)))
    return head(p, t["ParamHead_0"], x.mean(dim=(2, 3)))


def spec() -> Spec:
    out: Spec = []
    for i, (k, cin, cout, _, depthwise) in enumerate(_layers()):
        path = ("backbone", f"_ConvBN_{i}")
        _conv_leaf(out, path + ("Conv_0",), k, 1 if depthwise else cin,
                   cout)
        _bn_leaves(out, path + ("BatchNorm_0",), cout)
    _head_spec(out, ("backbone", "ParamHead_0"), 1024)
    return out + synergy_mlp_spec(1024)
