"""ViT-B/16 (Dosovitskiy et al. 2020, arXiv:2010.11929, equations 1-4 and
Table 1) with the 12/40/10 head: 16 x 16 patches of the 224 x 224 crop
projected to 768 by a stride-16 convolution with bias, a learned class
token in front and a learned position embedding added (197 tokens), 12
pre-LN blocks of 12-head self-attention and a 3,072-wide MLP with the
exact (erf) GELU, each added to the residual stream, and a final
LayerNorm (eps 1e-6, as in the paper's released code).

One departure from the paper: SynergyNet's 12/40/10 parameter head reads
the final LayerNorm's class token in place of the classifier.

The tree: ``embedding`` (kernel, bias), ``cls`` (1, 1, D),
``pos_embedding`` (1, T, D), ``encoderblock_{i}`` with ``LayerNorm_0``,
``qkv`` (one Dense of width 3D, laid out q | k | v, head h taking columns
``64 h .. 64 h + 63`` of each third), ``out``, ``LayerNorm_1``,
``Dense_0`` and ``Dense_1``, then ``encoder_norm`` and ``ParamHead_0``.
Heads are 64 wide; the depth, width, patch and token count are read from
the tree. Every product goes through the :class:`Precision`, the scores
and the attention-weighted values included; softmax, LayerNorm and GELU
in float32. Faces go through in blocks of ``BLOCK``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.nets import Spec, _head_spec, head, synergy_mlp_spec
from perfbench.reference.precision import Precision

HEAD_DIM = 64
EPS = 1e-6
BLOCK = 128


def _norm(node: dict, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * node["scale"] + node["bias"]


def _attend(p: Precision, node: dict, x):
    b, t, d = x.shape
    qkv = p.dense(_norm(node["LayerNorm_0"], x), node["qkv"]["kernel"],
                  node["qkv"]["bias"])
    q, k, v = qkv.reshape(b, t, 3, d // HEAD_DIM, HEAD_DIM).permute(
        2, 0, 3, 1, 4)
    scores = p.matmul(q, k.transpose(-1, -2)) / math.sqrt(HEAD_DIM)
    o = p.matmul(torch.softmax(scores, dim=-1), v)
    return p.dense(o.transpose(1, 2).reshape(b, t, d), node["out"]["kernel"],
                   node["out"]["bias"])


def _mlp(p: Precision, node: dict, x):
    h = _norm(node["LayerNorm_1"], x)
    h = F.gelu(p.dense(h, node["Dense_0"]["kernel"], node["Dense_0"]["bias"]))
    return p.dense(h, node["Dense_1"]["kernel"], node["Dense_1"]["bias"])


def _block(p: Precision, t: dict, x_nchw):
    k = t["embedding"]["kernel"]
    y = p.conv(x_nchw, k.permute(3, 2, 0, 1), t["embedding"]["bias"],
               k.shape[0])
    z = y.flatten(2).transpose(1, 2)                     # (B, N, D)
    z = torch.cat([t["cls"].expand(len(z), -1, -1), z], 1) \
        + t["pos_embedding"]
    i = 0
    while f"encoderblock_{i}" in t:
        node = t[f"encoderblock_{i}"]
        z = z + _attend(p, node, z)
        z = z + _mlp(p, node, z)
        i += 1
    return head(p, t["ParamHead_0"], _norm(t["encoder_norm"], z)[:, 0])


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor):
    """Normalized (B, S, S, 3) crops -> (B, 62) parameters."""
    x = x_nhwc.permute(0, 3, 1, 2)
    return torch.cat([_block(p, t, x[i:i + BLOCK])
                      for i in range(0, len(x), BLOCK)]
                     or [x.new_zeros((0, 62))])


def spec(width: int = 768, depth: int = 12, mlp: int = 3072,
         patch: int = 16, crop: int = 224) -> Spec:
    """The seeded tree at the published sizes (smaller ones for tests)."""
    out: Spec = []
    root = ("backbone",)
    tokens = (crop // patch) ** 2 + 1

    def leaf(path, shape, kind):
        out.append(("params", root + path, shape, kind))

    def norm(path):
        leaf(path + ("scale",), (width,), "bn_scale")
        leaf(path + ("bias",), (width,), "bn_bias")

    def dense(path, cin, cout):
        leaf(path + ("kernel",), (cin, cout), "dense")
        leaf(path + ("bias",), (cout,), "bias")

    leaf(("embedding", "kernel"), (patch, patch, 3, width), "kernel")
    leaf(("embedding", "bias"), (width,), "bias")
    leaf(("cls",), (1, 1, width), "bn_bias")
    leaf(("pos_embedding",), (1, tokens, width), "bn_bias")
    for i in range(depth):
        b = (f"encoderblock_{i}",)
        norm(b + ("LayerNorm_0",))
        dense(b + ("qkv",), width, 3 * width)
        dense(b + ("out",), width, width)
        norm(b + ("LayerNorm_1",))
        dense(b + ("Dense_0",), width, mlp)
        dense(b + ("Dense_1",), mlp, width)
    norm(("encoder_norm",))
    _head_spec(out, root + ("ParamHead_0",), width)
    return out + synergy_mlp_spec(width)
