"""Vision Transformer (Dosovitskiy et al. 2020, arXiv:2010.11929) with the
12/40/10 3DMM parameter head.

The paper's equations 1-4: the crop cut into P x P patches, each
projected to D (a P x P stride-P conv with bias), a learned class token
in front and a learned position embedding added (eq. 1); L pre-LN blocks,
``z = z + MSA(LN(z))`` (eq. 2) and ``z = z + MLP(LN(z))`` (eq. 3), the MLP
two biased Dense layers with the exact (erf) GELU between; the final
LayerNorm's class token (eq. 4) is the pooled feature, and SynergyNet's
``ParamHead_0`` reads it in place of the paper's classifier. LayerNorm eps
is 1e-6, as in the paper's released code. Multi-head attention projects q,
k and v with one Dense of width 3D (laid out q | k | v, each head h taking
columns ``h d .. (h + 1) d`` of its third) and attends through
:func:`synergynet_tpu_torch.nn.attention.attention`; no dropout runs inside
the blocks. ``vit_b16`` is ViT-B/16 at its published widths (224 x 224 in,
16 x 16 patches, 197 tokens, D 768, 12 blocks, 12 heads of 64, MLP 3072);
the factory's options build any other.

Numerics in the module dtype (:mod:`~synergynet_tpu_torch.nn.layers`):
the patch conv and every Dense are ``dtype`` GEMMs accumulated in f32,
LayerNorm takes its statistics in f32, and the residual stream is kept in
``dtype`` (bf16 for serving); the parameters, the class token and the
position embedding stay f32 until :func:`~synergynet_tpu_torch.nn.layers.
cast_layers_` rounds the layers' weights for serving, and the head runs
in f32 on the f32 class token.

The position embedding fixes the input's side, ``input_size``; the
serving API refuses another crop.

Module names are the flax names the weight bridge maps by path:
``embedding`` (the patch conv), ``cls`` (1, 1, D), ``pos_embedding``
(1, T, D), ``encoderblock_{i}`` (``LayerNorm_0``, ``qkv``, ``out``,
``LayerNorm_1``, ``Dense_0``, ``Dense_1``), ``encoder_norm``,
``ParamHead_0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.attention import attention
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, Dense, LayerNorm, to_nchw


class EncoderBlock(nn.Module):
    """One pre-LN block: eq. 2 then eq. 3 on (B, T, D) tokens."""

    def __init__(self, width: int, heads: int, mlp_dim: int, eps: float):
        super().__init__()
        self.heads = heads
        self.LayerNorm_0 = LayerNorm(width, eps)
        self.qkv = Dense(width, 3 * width)
        self.out = Dense(width, width)
        self.LayerNorm_1 = LayerNorm(width, eps)
        self.Dense_0 = Dense(width, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, width)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, t, d = z.shape
        qkv = self.qkv(self.LayerNorm_0(z))
        q, k, v = qkv.view(b, t, 3, self.heads, d // self.heads).permute(
            2, 0, 3, 1, 4)
        o = attention(q, k, v).transpose(1, 2).reshape(b, t, d)
        z = z + self.out(o)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(z)))
        return z + self.Dense_1(h)


class VisionTransformer(nn.Module):
    """NHWC (B, S, S, 3) normalized images, S = ``input_size`` ->
    ``(param62 (B, 62) fp32, class token (B, width) fp32)``. In train mode
    the head's dropout (rate ``dropout``) draws from the ``generator``
    passed to ``forward``."""

    def __init__(self, patch: int = 16, width: int = 768, depth: int = 12,
                 heads: int = 12, mlp_dim: int = 3072,
                 image_size: int = 224, eps: float = 1e-6,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch or width % heads:
            raise ValueError(f"image side {image_size} in patches of "
                             f"{patch}, width {width} over {heads} heads: "
                             "each must divide")
        self.dtype = dtype
        self.patch = patch
        self.input_size = image_size
        tokens = (image_size // patch) ** 2 + 1
        self.embedding = Conv2d(3, width, patch, patch, 0, bias=True)
        self.cls = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, width))
        for i in range(depth):
            self.add_module(f"encoderblock_{i}",
                            EncoderBlock(width, heads, mlp_dim, eps))
        self.depth = depth
        self.encoder_norm = LayerNorm(width, eps)
        self.ParamHead_0 = ParamHead(width, dropout=dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        patches = self.embedding(to_nchw(x, self.dtype))   # channels-last
        z = patches.permute(0, 2, 3, 1).reshape(b, -1, patches.shape[1])
        z = torch.cat([self.cls.to(z.dtype).expand(b, -1, -1), z], dim=1)
        z = z + self.pos_embedding.to(z.dtype)
        for i in range(self.depth):
            z = getattr(self, f"encoderblock_{i}")(z)
        feat = self.encoder_norm(z[:, 0]).float()
        return self.ParamHead_0(feat, generator), feat
