"""Shared 3DMM parameter head: three dropout + linear branches, concatenated
to 62.

Counterpart of ``synergynet_tpu/nn/heads.py``. Module names (``fc_pose``,
``fc_shape``, ``fc_exp`` and, with ``with_texture``, ``fc_texture``) are
the flax names. Each branch has its own Dropout(0.2) in train mode, as flax
draws one mask per ``drop_*`` module; in eval the dropout is the identity.
The optional 40-d texture branch is the extra head some reference
backbones carry (MobileNetV1, ResNet, GhostNet); its outputs follow the
62 parameters, and those backbones return ``param[:, :62]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; the mask comes from
    ``generator`` (on ``x``'s device)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ParamHead(nn.Module):
    def __init__(self, in_features: int, num_pose: int = 12,
                 num_shape: int = 40, num_exp: int = 10,
                 dropout: float = 0.2, with_texture: bool = False,
                 num_texture: int = 40):
        super().__init__()
        self.dropout = dropout
        self.fc_pose = nn.Linear(in_features, num_pose)
        self.fc_shape = nn.Linear(in_features, num_shape)
        self.fc_exp = nn.Linear(in_features, num_exp)
        self.branches = ("fc_pose", "fc_shape", "fc_exp")
        if with_texture:
            self.fc_texture = nn.Linear(in_features, num_texture)
            self.branches += ("fc_texture",)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # fp32 as in flax; flax's Dense then computes in its kernel's dtype.
        feat = feat.float().to(self.fc_pose.weight.dtype)
        rate = self.dropout if self.training else 0.0
        return torch.cat([getattr(self, fc)(dropout(feat, rate, generator))
                          for fc in self.branches], dim=1)
