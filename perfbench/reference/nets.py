"""The detector of the served pipeline, plainly, on flax-layout trees, and
the helpers that the regressors (:mod:`perfbench.reference.regressors`,
one module an architecture) share.

A tree is a nested dict of tensors under the flax module names, each
BatchNorm holding ``scale``, ``bias``, ``mean`` and ``var`` together
(:func:`merge` joins ``params`` and ``batch_stats``). Convolution kernels
are HWIO, dense kernels (in, out), as flax stores them. Activations are
NCHW inside, NHWC at the entries.

- FaceBoxes (Zhang et al. 2017, arXiv:1708.05234; the reference
  repository's ``FaceBoxes/models/faceboxes.py``): the unfolded net, a
  7x7/4 CReLU conv, BatchNorm as its own step, so the folding into the
  served stem is worked out again, not taken.
- The regressors' shared parts: :func:`conv`, :func:`bn`, the 12/40/10
  parameter :func:`head`, and the leaf specs of a convolution, a
  BatchNorm, the head and SynergyNet's landmark-refinement MLPs.

:func:`leaf_specs` lists every leaf a configuration's trees hold, with its
shape and kind, for the benchmark to draw seeded weights from.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import regressors
from perfbench.reference.precision import Precision

EPS = 1e-5
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
    ``regressor`` where the regressor module of ``arch`` draws one."""
    out = {"detector": faceboxes_spec()}
    reg = regressors.load(arch).spec()
    if reg is not None:
        out["regressor"] = reg
    return out
