"""SynergyNet inference forward: image crops -> 3DMM parameters.

Counterpart of ``synergynet_tpu/nn/synergy.py``'s ``SynergyNet.__call__``
(``:53-56``): the backbone regresses ``(param62, feat)``. The forward and
reverse synergy MLPs serve only the training criterion and come with the
training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from synergynet_tpu_torch.nn.backbones import make_backbone


class SynergyNet(nn.Module):
    """``forward((B, 120, 120, 3) normalized NHWC)`` -> ``((B, 62) params,
    (B, C) feat)``, both fp32."""

    def __init__(self, arch: str = "mobilenet_v2",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch = arch
        self.backbone = make_backbone(arch, dtype=dtype)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.backbone(images)

