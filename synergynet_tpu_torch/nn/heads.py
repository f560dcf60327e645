"""Shared 3DMM parameter head: three linear branches, concatenated to 62.

Counterpart of ``synergynet_tpu/nn/heads.py`` for inference: the branches'
Dropout(0.2) is the identity in eval, so only the linear layers remain.
Module names (``fc_pose``, ``fc_shape``, ``fc_exp``) are the flax names.
"""

from __future__ import annotations

import torch
from torch import nn


class ParamHead(nn.Module):
    def __init__(self, in_features: int, num_pose: int = 12,
                 num_shape: int = 40, num_exp: int = 10):
        super().__init__()
        self.fc_pose = nn.Linear(in_features, num_pose)
        self.fc_shape = nn.Linear(in_features, num_shape)
        self.fc_exp = nn.Linear(in_features, num_exp)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        feat = feat.float()
        return torch.cat([self.fc_pose(feat), self.fc_shape(feat),
                          self.fc_exp(feat)], dim=1)
