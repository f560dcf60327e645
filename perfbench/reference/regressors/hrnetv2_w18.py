"""HRNetV2-W18 (Wang et al., TPAMI 2020, arXiv:1908.07919) in its
facial-landmark form, with the 12/40/10 head: a stem of two 3x3 stride-2
convs of width 64, four Bottlenecks (64 -> 256, the first with a projected
shortcut), then four branches of 18, 36, 72 and 144 channels at 1/4 to
1/32 of the crop, each new branch made by a 3x3 stride-2 conv from the last
one; stages 2, 3 and 4 of 1, 4 and 3 modules, each branch of a module 4
BasicBlocks, each module ending in an exchange unit: output i is
relu(sum_j f_ij(x_j)), f_ii the identity, for j > i a 1x1 conv, BatchNorm
and a nearest upsample by 2^(j - i), for j < i (i - j) 3x3 stride-2 convs,
each but the last keeping branch j's width under BatchNorm + ReLU, the
last going to branch i's width under BatchNorm alone. The HRNetV2 head
upsamples branches 2-4 bilinearly (align_corners False) to branch 1's
extent, concatenates the four (270 channels) and applies a 1x1 conv with
bias, BatchNorm and ReLU.

One departure from the paper: SynergyNet's 12/40/10 parameter head reads
the global mean of those 270 channels in place of the heatmap conv.

The tree, in flax auto-names: ``Conv_0``/``BatchNorm_0`` and
``Conv_1``/``BatchNorm_1`` (stem), ``Bottleneck_{k}`` (``Conv_0`` ..
``Conv_2``, ``Conv_3`` for the projection), ``Conv_2``, ``Conv_3`` (the
first transition), ``HighResolutionModule_{k}`` (``BasicBlock_{b blocks +
m}`` for branch b, then the exchange unit's ``Conv_{k}``/``BatchNorm_{k}``
for each output i and input j != i in order), a ``Conv`` before each
stage that adds a branch, the head's ``Conv`` and ``BatchNorm``, then
``ParamHead_0``. Widths, depths and the branches of each module are read
from the tree. Every convolution goes through the :class:`Precision`;
faces go through in blocks of ``BLOCK``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.nets import (Spec, _bn_leaves, _conv_leaf,
                                      _head_spec, bn, conv, head,
                                      synergy_mlp_spec)
from perfbench.reference.precision import Precision

WIDTHS = (18, 36, 72, 144)
MODULES = (1, 4, 3)
BLOCKS = 4
STEM = 64
LAYER1 = 4
BLOCK = 128


def _paths(n: int):
    """The exchange unit's convs of ``n`` branches in creation order: (i, j,
    [(cin branch, cout branch, kernel, stride, relu) per conv])."""
    out = []
    for i in range(n):
        for j in range(n):
            if j > i:
                out.append((i, j, [(j, i, 1, 1, False)]))
            elif j < i:
                out.append((i, j, [(j, j if k < i - j - 1 else i, 3, 2,
                                    k < i - j - 1) for k in range(i - j)]))
    return out


def _unit(p, t, name, x, stride=1, relu=True):
    y = bn(t[f"BatchNorm_{name}"], conv(p, t[f"Conv_{name}"], x, stride))
    return F.relu(y) if relu else y


def _bottleneck(p, node, x):
    y = _unit(p, node, 0, x)
    y = _unit(p, node, 1, y)
    y = _unit(p, node, 2, y, relu=False)
    if "Conv_3" in node:
        x = _unit(p, node, 3, x, relu=False)
    return F.relu(x + y)


def _basic(p, node, x):
    y = _unit(p, node, 0, x)
    return F.relu(x + _unit(p, node, 1, y, relu=False))


def _module(p, node, xs):
    n = len(xs)
    blocks = sum(k.startswith("BasicBlock_") for k in node) // n
    xs = list(xs)
    for b in range(n):
        for m in range(blocks):
            xs[b] = _basic(p, node[f"BasicBlock_{b * blocks + m}"], xs[b])
    out = list(xs)
    k = 0
    for i, j, convs in _paths(n):
        y = xs[j]
        for _, _, _, stride, relu in convs:
            y = _unit(p, node, k, y, stride, relu)
            k += 1
        if j > i:
            y = F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
        out[i] = out[i] + y
    return [F.relu(y) for y in out]


def _branches(node) -> int:
    """A module's branch count: the distinct widths of its BasicBlocks."""
    return len({v["Conv_0"]["kernel"].shape[-1] for k, v in node.items()
                if k.startswith("BasicBlock_")})


def _block(p: Precision, t: dict, x):
    x = _unit(p, t, 0, x, 2)
    x = _unit(p, t, 1, x, 2)
    k = 0
    while f"Bottleneck_{k}" in t:
        x = _bottleneck(p, t[f"Bottleneck_{k}"], x)
        k += 1
    xs = [_unit(p, t, 2, x), _unit(p, t, 3, x, 2)]
    conv_k, k = 4, 0
    while f"HighResolutionModule_{k}" in t:
        node = t[f"HighResolutionModule_{k}"]
        if _branches(node) > len(xs):
            xs.append(_unit(p, t, conv_k, xs[-1], 2))
            conv_k += 1
        xs = _module(p, node, xs)
        k += 1
    size = xs[0].shape[2:]
    y = torch.cat([xs[0]] + [F.interpolate(
        z, size=size, mode="bilinear", align_corners=False) for z in xs[1:]],
        dim=1)
    y = _unit(p, t, conv_k, y)
    return head(p, t["ParamHead_0"], y.mean(dim=(2, 3)))


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, S, S, 3) crops, S a multiple of 32 -> (B, 62)
    parameters."""
    x = x_nhwc.permute(0, 3, 1, 2)
    return torch.cat([_block(p, t, x[i:i + BLOCK])
                      for i in range(0, len(x), BLOCK)]
                     or [x.new_zeros((0, 62))])


def spec(modules=MODULES) -> Spec:
    """The seeded tree at the published widths and depths (fewer modules for
    tests). The last BatchNorm of every BasicBlock and
    Bottleneck is a residual branch's (drawn at a fifth of the scale)."""
    out: Spec = []
    root = ("backbone",)
    widths, blocks = WIDTHS, BLOCKS

    def unit(path, k, size, cin, cout, kind="bn_scale", bias=False):
        _conv_leaf(out, path + (f"Conv_{k}",), size, cin, cout, bias)
        _bn_leaves(out, path + (f"BatchNorm_{k}",), cout, kind)

    unit(root, 0, 3, 3, STEM)
    unit(root, 1, 3, STEM, STEM)
    cin = STEM
    for b in range(LAYER1):
        path = root + (f"Bottleneck_{b}",)
        unit(path, 0, 1, cin, 64)
        unit(path, 1, 3, 64, 64)
        unit(path, 2, 1, 64, 256, "bn_scale_residual")
        if cin != 256:
            unit(path, 3, 1, cin, 256)
        cin = 256
    unit(root, 2, 3, 256, widths[0])
    unit(root, 3, 3, 256, widths[1])
    conv_k, m = 4, 0
    for stage, n_modules in enumerate(modules):
        n = stage + 2
        if n > 2:
            unit(root, conv_k, 3, widths[n - 2], widths[n - 1])
            conv_k += 1
        for _ in range(n_modules):
            path = root + (f"HighResolutionModule_{m}",)
            for b in range(n * blocks):
                c = widths[b // blocks]
                blk = path + (f"BasicBlock_{b}",)
                unit(blk, 0, 3, c, c)
                unit(blk, 1, 3, c, c, "bn_scale_residual")
            k = 0
            for _, _, convs in _paths(n):
                for ci, co, size, _, _ in convs:
                    unit(path, k, size, widths[ci], widths[co])
                    k += 1
            m += 1
    width = sum(widths)
    unit(root, conv_k, 1, width, width, bias=True)
    _head_spec(out, root + ("ParamHead_0",), width)
    return out + synergy_mlp_spec(width)
