"""Synergy MLPs: landmark refinement (forward) and landmark-to-3DMM
(reverse).

Counterpart of ``synergynet_tpu/nn/pointnet.py`` (reference
backbone_nets/pointnet_backbone.py:7-105). The layout is (B, N, C): each
1x1 Conv1d of the reference is an ``nn.Linear`` over the point axis, and
BatchNorm reduces over (batch, point). Module names are the flax names
(``PointEncoder_0``, ``enc1_fc``, ``enc1_bn``, ``dec1_fc``, ...), so
:mod:`synergynet_tpu_torch.convert` maps a flax tree by path.

As in the JAX package (and the reference), the output layers keep their
BatchNorm and ReLU (``pointnet.py:8-19``), and ``MLPFor`` takes 2,418
input channels per point (quirk Q1). The global feature is
``torch.amax`` over the points, which splits the gradient over ties as
``jnp.max`` does (``torch.max(dim=...)`` would send it to one index).
Everything here is fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm


def _add_layers(parent: nn.Module, spec) -> Tuple[str, ...]:
    """Register ``{name}_fc`` (Linear) and ``{name}_bn`` for each
    ``(name, cin, cout)`` of ``spec``; returns the names in order."""
    for name, cin, cout in spec:
        parent.add_module(f"{name}_fc", nn.Linear(cin, cout))
        parent.add_module(f"{name}_bn", BatchNorm(cout, channel_dim=-1))
    return tuple(name for name, _, _ in spec)


def _dense_bn_relu(parent: nn.Module, name: str, x: torch.Tensor
                   ) -> torch.Tensor:
    fc, bn = getattr(parent, f"{name}_fc"), getattr(parent, f"{name}_bn")
    return F.relu(bn(fc(x)))


class PointEncoder(nn.Module):
    """Per-point 3->64->64 (point features), then 64->128->1024 and a max
    over the points (global feature)."""

    def __init__(self):
        super().__init__()
        self._enc = _add_layers(self, (
            ("enc1", 3, 64), ("enc2", 64, 64), ("enc3", 64, 64),
            ("enc4", 64, 128), ("enc5", 128, 1024)))

    def forward(self, pts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = pts
        for name in self._enc[:2]:
            x = _dense_bn_relu(self, name, x)
        point_feat = x                                    # (B, N, 64)
        for name in self._enc[2:]:
            x = _dense_bn_relu(self, name, x)
        return point_feat, torch.amax(x, dim=1)           # (B, 1024)


class MLPFor(nn.Module):
    """(B, N, 3) landmarks + backbone feature + shape/exp codes -> (B, N, 3)
    non-negative residual."""

    def __init__(self, feat_dim: int = 1280):
        super().__init__()
        self.PointEncoder_0 = PointEncoder()
        self._dec = _add_layers(self, (
            ("dec1", 64 + 1024 + feat_dim + 50, 512), ("dec2", 512, 256),
            ("dec3", 256, 128), ("dec4", 128, 3)))

    def forward(self, lmk, backbone_feat, shape_code, exp_code):
        n_pts = lmk.shape[1]
        point_feat, global_feat = self.PointEncoder_0(lmk)

        def tile(v):  # (B, C) -> (B, N, C)
            return v[:, None, :].expand(v.shape[0], n_pts, v.shape[1])

        x = torch.cat([point_feat, tile(global_feat), tile(backbone_feat),
                       tile(shape_code), tile(exp_code)], dim=-1)
        for name in self._dec:
            x = _dense_bn_relu(self, name, x)
        return x


class MLPRev(nn.Module):
    """Refined landmarks (B, N, 3) -> 62-d 3DMM parameters: the PointNet
    trunk's global feature, three BN + ReLU heads (12 / 40 / 10)."""

    def __init__(self):
        super().__init__()
        self.PointEncoder_0 = PointEncoder()
        self._heads = _add_layers(self, (
            ("head_rot", 1024, 12), ("head_shape", 1024, 40),
            ("head_exp", 1024, 10)))

    def forward(self, lmk: torch.Tensor) -> torch.Tensor:
        _, global_feat = self.PointEncoder_0(lmk)
        g = global_feat[:, None, :]                       # (B, 1, 1024)
        return torch.cat([_dense_bn_relu(self, h, g) for h in self._heads],
                         dim=-1)[:, 0, :]
