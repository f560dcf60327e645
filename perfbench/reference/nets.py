"""The three networks of the served pipeline, plainly, on flax-layout trees.

A tree is a nested dict of tensors under the flax module names, each
BatchNorm holding ``scale``, ``bias``, ``mean`` and ``var`` together
(:func:`merge` joins ``params`` and ``batch_stats``). Convolution kernels
are HWIO, dense kernels (in, out), as flax stores them. Activations are
NCHW inside, NHWC at the entries.

- FaceBoxes (Zhang et al. 2017, arXiv:1708.05234; the reference
  repository's ``FaceBoxes/models/faceboxes.py``): the unfolded net, a
  7x7/4 CReLU conv, BatchNorm as its own step, so the folding into the
  served stem is worked out again, not taken.
- MobileNetV2 1.0 (Sandler et al. 2018, arXiv:1801.04381; the reference's
  ``backbone_nets/mobilenetv2_backbone.py``) with the 12/40/10 head.
- ResNeSt-50 (Zhang et al. 2020, arXiv:2004.08955; the reference's
  ``backbone_nets/ResNeSt/resnest.py``): deep stem of width 32, radix 2,
  cardinality 1, bottleneck width 64, ``avg_down``, ``avd`` after the
  split attention.

:func:`leaf_specs` lists every leaf a configuration's trees hold, with its
shape and kind, for the benchmark to draw seeded weights from.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

EPS = 1e-5
MBV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
RESNEST50_LAYERS = (3, 4, 6, 3)
RADIX = 2
STEM_WIDTH = 32
HEAD = (("fc_pose", 12), ("fc_shape", 40), ("fc_exp", 10))

# FaceBoxes: (module, kernel, cin, cout, stride, pad, crelu)
FACEBOXES_CONVS = (
    ("conv1", 7, 3, 24, 4, 3, True), ("conv2", 5, 48, 64, 2, 2, True),
    ("conv3_1", 1, 128, 128, 1, 0, False),
    ("conv3_2", 3, 128, 256, 2, 1, False),
    ("conv4_1", 1, 256, 128, 1, 0, False),
    ("conv4_2", 3, 128, 256, 2, 1, False))
INCEPTION = (("branch1x1", 1, 128, 32), ("branch1x1_2", 1, 128, 32),
             ("branch3x3_reduce", 1, 128, 24), ("branch3x3", 3, 24, 32),
             ("branch3x3_reduce_2", 1, 128, 24), ("branch3x3_2", 3, 24, 32),
             ("branch3x3_3", 3, 32, 32))
FACEBOXES_HEADS = (("loc", (21 * 4, 4, 4)), ("conf", (21 * 2, 2, 2)))
FACEBOXES_SOURCES = (128, 256, 256)


def merge(params: dict, stats: dict) -> dict:
    """flax ``params`` + ``batch_stats`` -> one tree (stats under their
    BatchNorm's node)."""
    out = {}
    for k, v in params.items():
        out[k] = merge(v, stats.get(k, {})) if isinstance(v, dict) else v
    for k, v in stats.items():
        if not isinstance(v, dict):
            out[k] = v
        elif k not in out:
            out[k] = merge({}, v)
    return out


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(3, 2, 0, 1)


def conv(p: Precision, node: dict, x, stride=1, pad=None):
    """flax ``Conv`` (bias where the node has one); groups from the
    kernel's input extent."""
    k = node["kernel"]
    pad = (k.shape[0] - 1) // 2 if pad is None else pad
    y = p.conv(x, _oihw(k), None, stride, pad, x.shape[1] // k.shape[2])
    if "bias" in node:
        y = y + node["bias"].reshape(1, -1, 1, 1)
    return y


def bn(node: dict, x):
    """BatchNorm with running statistics (eval), float32. A node marked
    ``calibrate`` first takes its statistics from this input, where the
    input is a feature map (a pooled vector of seeded noise barely varies
    over a batch, and its statistics would divide by near zero)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if node.pop("calibrate", False) and x[0, 0].numel() > 1:
        dims = [0] + list(range(2, x.dim()))
        node["mean"] = x.mean(dims)
        node["var"] = x.var(dims, unbiased=False)
    mul = torch.rsqrt(node["var"] + EPS) * node["scale"]
    return (x - node["mean"].reshape(shape)) * mul.reshape(shape) \
        + node["bias"].reshape(shape)


def head(p: Precision, node: dict, feat):
    return torch.cat([p.dense(feat, node[n]["kernel"], node[n]["bias"])
                      for n, _ in HEAD], dim=1)


# -- FaceBoxes ----------------------------------------------------------------

def _unit(p, node, x, stride=1, pad=None, crelu=False):
    y = bn(node["bn"], conv(p, node["conv"], x, stride, pad))
    if crelu:
        y = torch.cat([y, -y], dim=1)
    return F.relu(y)


def _inception(p, node, x):
    b0 = _unit(p, node["branch1x1"], x)
    pool = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
    b1 = _unit(p, node["branch1x1_2"], pool)
    b2 = _unit(p, node["branch3x3"], _unit(p, node["branch3x3_reduce"], x))
    b3 = _unit(p, node["branch3x3_3"], _unit(
        p, node["branch3x3_2"], _unit(p, node["branch3x3_reduce_2"], x)))
    return torch.cat([b0, b1, b2, b3], dim=1)


def faceboxes(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Mean-subtracted BGR (B, H, W, 3) -> (loc (B, A, 4), conf (B, A, 2)),
    anchors in (source, row, column, anchor) order."""
    x = x_nhwc.permute(0, 3, 1, 2)
    spec = {c[0]: c for c in FACEBOXES_CONVS}
    _, _, _, _, s, pad, cr = spec["conv1"]
    x = F.max_pool2d(_unit(p, t["conv1"], x, s, pad, cr), 3, 2, 1)
    _, _, _, _, s, pad, cr = spec["conv2"]
    x = F.max_pool2d(_unit(p, t["conv2"], x, s, pad, cr), 3, 2, 1)
    for i in (1, 2, 3):
        x = _inception(p, t[f"inception{i}"], x)
    sources = [x]
    for a, b in (("conv3_1", "conv3_2"), ("conv4_1", "conv4_2")):
        x = _unit(p, t[a], x, spec[a][4], spec[a][5])
        x = _unit(p, t[b], x, spec[b][4], spec[b][5])
        sources.append(x)
    locs, confs = [], []
    for i, src in enumerate(sources):
        n = src.shape[0]
        locs.append(conv(p, t[f"loc{i}"], src, 1, 1).permute(0, 2, 3, 1)
                    .reshape(n, -1, 4))
        confs.append(conv(p, t[f"conf{i}"], src, 1, 1).permute(0, 2, 3, 1)
                     .reshape(n, -1, 2))
    return torch.cat(locs, 1), torch.cat(confs, 1)


# -- MobileNetV2 --------------------------------------------------------------

def _cbr6(p, node, x, stride=1):
    return torch.clamp(bn(node["BatchNorm_0"],
                          conv(p, node["Conv_0"], x, stride)), 0.0, 6.0)


def mobilenet_v2(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, 120, 120, 3) crops -> (B, 62) parameters."""
    x = _cbr6(p, t["ConvBNReLU6_0"], x_nhwc.permute(0, 3, 1, 2), 2)
    i, cin = 0, 32
    for e, c, n, s in MBV2_SETTING:
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


# -- ResNeSt-50 ---------------------------------------------------------------

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


def resnest50(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, 120, 120, 3) crops -> (B, 62) parameters."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for i in range(3):
        x = F.relu(bn(t[f"BatchNorm_{i}"],
                      conv(p, t[f"Conv_{i}"], x, 2 if i == 0 else 1)))
    x = F.max_pool2d(x, 3, 2, 1)
    k, cin = 0, 2 * STEM_WIDTH
    for stage, n in enumerate(RESNEST50_LAYERS):
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


REGRESSORS = {"mobilenet_v2": mobilenet_v2, "resnest50": resnest50}


# -- leaf specs, for seeded weights -------------------------------------------

Spec = List[Tuple[str, Tuple[str, ...], Tuple[int, ...], str]]


def _conv_leaf(out: Spec, path, k, cin, cout, bias=False):
    out.append(("params", path + ("kernel",), (k, k, cin, cout), "kernel"))
    if bias:
        out.append(("params", path + ("bias",), (cout,), "bias"))


def _bn_leaves(out: Spec, path, c, scale="bn_scale"):
    out.append(("params", path + ("scale",), (c,), scale))
    out.append(("params", path + ("bias",), (c,), "bn_bias"))
    out.append(("batch_stats", path + ("mean",), (c,), "bn_mean"))
    out.append(("batch_stats", path + ("var",), (c,), "bn_var"))


def faceboxes_spec() -> Spec:
    out: Spec = []
    units = [(n, k, cin, cout) for n, k, cin, cout, *_ in FACEBOXES_CONVS]
    units += [(f"inception{i}/{b}", k, cin, cout)
              for i in (1, 2, 3) for b, k, cin, cout in INCEPTION]
    for name, k, cin, cout in units:
        path = tuple(name.split("/"))
        _conv_leaf(out, path + ("conv",), k, cin, cout)
        _bn_leaves(out, path + ("bn",), cout)
    for i, cin in enumerate(FACEBOXES_SOURCES):
        for name, couts in FACEBOXES_HEADS:
            _conv_leaf(out, (f"{name}{i}",), 3, cin, couts[i], bias=True)
    return out


def _head_spec(out: Spec, path, cin):
    for name, n in HEAD:
        out.append(("params", path + (name, "kernel"), (cin, n), "dense"))
        out.append(("params", path + (name, "bias"), (n,), "bias"))


def resnest50_spec() -> Spec:
    out: Spec = []
    root = ("backbone",)
    cin = 3
    for i, c in enumerate((STEM_WIDTH, STEM_WIDTH, 2 * STEM_WIDTH)):
        _conv_leaf(out, root + (f"Conv_{i}",), 3, cin, c)
        _bn_leaves(out, root + (f"BatchNorm_{i}",), c)
        cin = c
    k = 0
    for stage, n in enumerate(RESNEST50_LAYERS):
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
    return out


def synergy_mlp_spec(feat_dim: int) -> Spec:
    """The landmark-refinement MLPs every SynergyNet tree carries
    (``forward_direction``, ``reverse_direction``). Serving never runs
    them; a loaded tree holds them."""
    out: Spec = []

    def layer(path, cin, cout):
        out.append(("params", path + ("_fc", "kernel"), (cin, cout), "dense"))
        out.append(("params", path + ("_fc", "bias"), (cout,), "bias"))
        _bn_leaves(out, path + ("_bn",), cout)

    enc = (("enc1", 3, 64), ("enc2", 64, 64), ("enc3", 64, 64),
           ("enc4", 64, 128), ("enc5", 128, 1024))
    for mlp, rest in (("forward_direction",
                       (("dec1", 64 + 1024 + feat_dim + 50, 512),
                        ("dec2", 512, 256), ("dec3", 256, 128),
                        ("dec4", 128, 3))),
                      ("reverse_direction",
                       (("head_rot", 1024, 12), ("head_shape", 1024, 40),
                        ("head_exp", 1024, 10)))):
        for name, cin, cout in enc:
            layer((mlp, "PointEncoder_0", name), cin, cout)
        for name, cin, cout in rest:
            layer((mlp, name), cin, cout)
    # "enc1" + "_fc" -> "enc1_fc": join the suffix onto the module name.
    return [(col, path[:-3] + (path[-3] + path[-2], path[-1]), shape, kind)
            if path[-2] in ("_fc", "_bn") else (col, path, shape, kind)
            for col, path, shape, kind in out]


def leaf_specs(arch: str) -> Dict[str, Spec]:
    """The seeded trees of a configuration: ``detector`` always,
    ``regressor`` where the configuration draws its regressor."""
    out = {"detector": faceboxes_spec()}
    if arch == "resnest50":
        out["regressor"] = resnest50_spec() + synergy_mlp_spec(2048)
    return out
