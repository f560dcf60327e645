"""The sparse mixture-of-experts MLP of V-MoE (Riquelme et al. 2021,
arXiv:2106.05974), served dropless.

:class:`MoeMlp` takes a transformer block's residual stream ``z`` and its
layer-normed tokens ``u`` and returns ``z + MoE(u)``, the paper's

- ``g(u) = TOP_k(softmax(W_r u))``: the router ``W_r`` (no bias) scores
  each token against the E experts in f32, and all but the k = 2 largest
  probabilities are zeroed; the two kept are not renormalised, and a tie
  goes to the lower expert. The paper's training noise is off at
  inference;
- ``MoE(u) = sum over i of g(u)_i MLP_i(u)``, each expert ViT's MLP
  (``Dense_0`` D -> H, the exact GELU, ``Dense_1`` H -> D, with biases).

Every token reaches both of its experts: there is no capacity, so which
tokens are served depends neither on the order of the batch nor on
rounding (V-MoE serves with a capacity ratio and Batch Prioritized
Routing; dropless departs from it). The sum ``g1 y1 + g2 y2`` is taken in
f32 with the residual added and rounded once to the stream's dtype.

Precision: the router's weight is a plain ``nn.Linear`` (not a
:class:`~synergynet_tpu_torch.nn.layers.Dense`), so
:func:`~synergynet_tpu_torch.nn.layers.cast_layers_` leaves it in f32 and
the logits are f32 products of the stream's tokens; the experts' stacked
weights are :class:`~synergynet_tpu_torch.nn.layers.ExpertDense` and round
to the serving dtype with the rest of the net (a training net's f32
experts are cast to the tokens' dtype each call, as a ``Dense`` casts).

The work runs in :func:`synergynet_tpu_torch.ops.moe.moe_mlp`: kernels M1
(route and dispatch), G1 (the grouped expert GEMM, twice) and M2 (combine)
on a card, their twins on the CPU. Inside a stamped program body the layer
adds to the program's tallies (its ``tallies``) ``moe_rows`` (the (token, expert) rows it
routed, 2T) and ``moe_rows_max`` (its busiest expert's rows), written by M1
on the device; under a profiler its body is the span ``synergy.moe``. A
list in ``routes`` receives each call's (T, 2) expert choices.

Module names are the flax names the weight bridge maps by path: ``Router``
(kernel (D, E)), ``Dense_0`` (kernel (E, D, H), bias (E, H)), ``Dense_1``
(kernel (E, H, D), bias (E, D)).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from synergynet_tpu_torch.core.profiling import annotate, tally
from synergynet_tpu_torch.nn.layers import ExpertDense
from synergynet_tpu_torch.ops.moe import moe_mlp


class MoeMlp(nn.Module):
    """``MoeMlp(width, mlp_dim, experts)``: ``forward(z, u)`` -> ``z +
    MoE(u)`` on (B, T, D) tensors, each token routed to 2 experts (module
    doc)."""

    # The csrc library its kernels load from, built when an engine is made;
    # the tallies it adds to, which a program that serves it holds.
    kernels = ("moe",)
    tallies = ("moe_rows", "moe_rows_max")

    def __init__(self, width: int, mlp_dim: int, experts: int):
        super().__init__()
        self.Router = nn.Linear(width, experts, bias=False)
        self.Dense_0 = ExpertDense(experts, width, mlp_dim)
        self.Dense_1 = ExpertDense(experts, mlp_dim, width)
        self.routes: Optional[List[torch.Tensor]] = None

    def forward(self, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        with annotate("synergy.moe"):
            d = z.shape[-1]
            w1, w2 = self.Dense_0, self.Dense_1
            cast = [t.to(u.dtype) for t in (w1.weight, w1.bias, w2.weight,
                                             w2.bias)]
            out, disp = moe_mlp(z.reshape(-1, d), u.reshape(-1, d),
                                self.Router.weight.float(), *cast)
            tally(lambda: disp.stats, self.tallies)
            if self.routes is not None:
                self.routes.append(disp.expert)
            return out.reshape(z.shape)
