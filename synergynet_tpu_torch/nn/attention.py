"""Scaled dot-product attention: the one function the port's transformer
blocks attend through.

:func:`attention` computes ``softmax(q k^T / sqrt(d)) v`` for every head.
On a CUDA tensor it runs ``F.scaled_dot_product_attention`` with its
backend pinned to FlashAttention (``SDPBackend.FLASH_ATTENTION``: one fused
kernel a call, scores and softmax in f32 on chip, never written to
memory). Where FlashAttention cannot take the inputs (an f32 tensor, a
head wider than 256) it raises; nothing falls back to the math backend on
a card. In a device trace the kernels' names hold ``flash_fwd``
(``flash_fwd_kernel``, or ``flash_fwd_splitkv_kernel`` and its combine
kernel), the fragment the benchmark reads them by. On the CPU it runs the
plain product in f32 and rounds the result once to the inputs' dtype.

``launches["attention"]``, in the launch table of
:mod:`synergynet_tpu_torch.ops.cuda_build`, counts the calls, one fused
launch each on a card; a captured program credits it on every replay
(:mod:`synergynet_tpu_torch.pipeline.program`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.ops.cuda_build import launches


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """(B, H, T, d) queries, keys and values (any strides with the last
    axis contiguous) -> (B, H, T, d) in their dtype."""
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            out = F.scaled_dot_product_attention(q, k, v)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        weights = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1)
        out = torch.matmul(weights, v.float()).to(q.dtype)
    launches["attention"] += 1
    return out
