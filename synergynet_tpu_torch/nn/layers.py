"""The layers every backbone family builds from, computed as flax computes
them in the module's dtype.

- :class:`Conv2d` is flax's ``nn.Conv``: the weight, and the bias where
  the conv has one, are cast to the input's dtype (flax casts kernel and
  bias to the module dtype), and the bias is added after the conv in that
  dtype, as flax adds it. The fp32 parameters of training then compute in
  bf16; a serving model stores them in the compute dtype already
  (:func:`cast_layers_`), and the casts are no-ops.
- :class:`Dense` and :class:`LayerNorm` are the transformer blocks' layers
  in the same form: weight and bias cast to the input's dtype. A bf16
  Dense is one bf16 GEMM with the bias in its epilogue, accumulated in
  f32; a bf16 LayerNorm takes its mean and variance in f32 and rounds its
  output once.
- :func:`cast_layers_` rounds every conv, Dense and LayerNorm weight and
  bias once, so a bf16 serving model rounds the 1x1 biased convs
  (ResNeSt's ``fc1``/``fc2``, GhostNet's squeeze-excite and head conv) as
  flax rounds them per call. The parameter head's plain ``nn.Linear``
  layers stay f32.
- :func:`to_nchw` and :func:`spatial_mean` are the backbones' entry
  (NHWC in, channels-last NCHW inside) and ``jnp.mean`` over the spatial
  axes (an fp32 accumulator, one rounding to the input's dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``Conv2d(cin, cout, kernel, stride, padding, groups=, bias=)``,
    bias-free unless asked, in the input's dtype (see the module doc)."""

    def __init__(self, *args, bias: bool = False, **kwargs):
        super().__init__(*args, bias=bias, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return y


class Dense(nn.Linear):
    """``Dense(cin, cout)``, biased, in the input's dtype (module doc)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``LayerNorm(width, eps)`` over the last axis, in the input's dtype
    (module doc)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def cast_layers_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every conv, :class:`Dense` and :class:`LayerNorm` weight and
    bias of ``model`` in ``dtype`` (in place), for inference: they round to
    ``dtype`` once, as the per-call cast of a training model rounds them
    each call."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, Dense, LayerNorm)):
            m.to(dtype)
    return model


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in ``dtype``, channels-last in memory."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def spatial_mean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean`` over H and W of an NCHW tensor: accumulated in fp32
    (float64 for float64), rounded once to ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.mean(dim=(2, 3), dtype=acc, keepdim=keepdim).to(x.dtype)
