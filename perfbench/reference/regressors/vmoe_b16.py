"""V-MoE-B/16 (Riquelme et al. 2021, arXiv:2106.05974) with the 12/40/10
head: ViT-B/16 (``vit_b16.py``, whose patch embedding, attention,
LayerNorm and head it reuses) with the MLP of every other block (1, 3, 5,
7, 9 and 11, 0-based: "Every-2") replaced by a sparse mixture of 32
experts, each token sent to the top 2:

- ``u = LN_2(z)``; ``g(u) = TOP_2(softmax(u W_r))``, the router ``W_r``
  (D x E, no bias) through the :class:`Precision`, all but the two largest
  probabilities zeroed and the two kept not renormalised, a tie to the
  lower expert (a stable sort);
- ``z <- z + sum over e of g(u)_e MLP_e(u)``, written as the paper's sum:
  for each expert, the tokens whose top two hold it selected by plain
  indexing, run through the expert's MLP (768 -> 3,072 -> 768, biases,
  the exact GELU), weighted by their gate and added. Every token reaches
  both of its experts (dropless: no capacity).

The tree is ``vit_b16``'s but for the MoE blocks, whose ``Moe`` holds
``Router`` (kernel (D, E)), ``Dense_0`` (kernel (D, E, H), bias (E, H))
and ``Dense_1`` (kernel (H, E, D), bias (E, D)): each expert's kernel is
the middle axis's slice, fan-in first, so the seeded draw scales it
lecun-normal. The MoE blocks and the expert count are read from the tree.
Every product goes through the :class:`Precision`; softmax, LayerNorm and
GELU in float32. Faces go through in blocks of ``vit_b16.BLOCK``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.nets import Spec, head
from perfbench.reference.precision import Precision
from perfbench.reference.regressors import vit_b16 as vit

MOE_BLOCKS = (1, 3, 5, 7, 9, 11)
EXPERTS = 32
TOP_K = 2


def route(p: Precision, router: dict, u: torch.Tensor):
    """(N, D) tokens -> (gates (N, 2), experts (N, 2)): the two largest
    router probabilities, best first, a tie to the lower expert."""
    probs = torch.softmax(p.matmul(u, router["kernel"]), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[:, :TOP_K], expert[:, :TOP_K]


def moe(p: Precision, node: dict, u: torch.Tensor,
        routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """(N, D) layer-normed tokens -> (N, D): the gate-weighted sum of each
    token's two experts (module doc)."""
    gate, expert = route(p, node["Router"], u)
    if routes is not None:
        routes.append(expert)
    d0, d1 = node["Dense_0"], node["Dense_1"]
    out = torch.zeros_like(u)
    for e in range(d0["kernel"].shape[1]):
        hit = expert == e
        rows = hit.any(-1).nonzero().squeeze(1)
        if not len(rows):
            continue
        h = F.gelu(p.dense(u[rows], d0["kernel"][:, e], d0["bias"][e]))
        y = p.dense(h, d1["kernel"][:, e], d1["bias"][e])
        out.index_add_(0, rows, (gate * hit).sum(-1)[rows, None] * y)
    return out


def _block(p: Precision, t: dict, x_nchw, routes):
    k = t["embedding"]["kernel"]
    y = p.conv(x_nchw, k.permute(3, 2, 0, 1), t["embedding"]["bias"],
               k.shape[0])
    z = y.flatten(2).transpose(1, 2)                     # (B, N, D)
    z = torch.cat([t["cls"].expand(len(z), -1, -1), z], 1) \
        + t["pos_embedding"]
    i = 0
    while f"encoderblock_{i}" in t:
        node = t[f"encoderblock_{i}"]
        z = z + vit._attend(p, node, z)
        if "Moe" in node:
            u = vit._norm(node["LayerNorm_1"], z)
            z = z + moe(p, node["Moe"], u.reshape(-1, u.shape[-1]),
                        routes).reshape(z.shape)
        else:
            z = z + vit._mlp(p, node, z)
        i += 1
    return head(p, t["ParamHead_0"], vit._norm(t["encoder_norm"], z)[:, 0])


def forward(p: Precision, t: dict, x_nhwc: torch.Tensor,
            routes: Optional[List[torch.Tensor]] = None):
    """Normalized (B, S, S, 3) crops -> (B, 62) parameters; a list in
    ``routes`` receives each MoE layer's (tokens, 2) experts, block by
    block of faces."""
    x = x_nhwc.permute(0, 3, 1, 2)
    return torch.cat([_block(p, t, x[i:i + vit.BLOCK], routes)
                      for i in range(0, len(x), vit.BLOCK)]
                     or [x.new_zeros((0, 62))])


def spec(width: int = 768, depth: int = 12, mlp: int = 3072,
         patch: int = 16, crop: int = 224, experts: int = EXPERTS,
         moe_blocks=MOE_BLOCKS) -> Spec:
    """The seeded tree at the published sizes (smaller ones for tests):
    ``vit_b16``'s, each MoE block's ``Dense_0`` / ``Dense_1`` replaced by
    its ``Moe``."""
    out: Spec = []
    for col, path, shape, kind in vit.spec(width, depth, mlp, patch, crop):
        block = path[1] if len(path) > 2 else ""
        if not (block.startswith("encoderblock_")
                and int(block.split("_")[1]) in moe_blocks
                and path[2] in ("Dense_0", "Dense_1")):
            out.append((col, path, shape, kind))
        elif path[2:] == ("Dense_1", "bias"):
            moe_node = path[:2] + ("Moe",)
            out += [
                (col, moe_node + ("Router", "kernel"), (width, experts),
                 "dense"),
                (col, moe_node + ("Dense_0", "kernel"),
                 (width, experts, mlp), "dense"),
                (col, moe_node + ("Dense_0", "bias"), (experts, mlp),
                 "bias"),
                (col, moe_node + ("Dense_1", "kernel"),
                 (mlp, experts, width), "dense"),
                (col, moe_node + ("Dense_1", "bias"), (experts, width),
                 "bias")]
    return out
