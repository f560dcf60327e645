"""SynergyNet: image -> 3DMM parameters, with the forward and reverse
synergy MLPs and the 5-term training criterion.

Counterpart of ``synergynet_tpu/nn/synergy.py`` (reference
model_building.py:65-165): the backbone regresses ``(param62, feat)``;
``refine`` adds ``0.05 * MLPFor(...)`` to decoded landmarks; ``reverse``
regresses the parameters back from refined landmarks.
:func:`synergy_criterion` is the reference's 5-term loss, taking the
``ParamPack`` as an argument. ``model.train()`` puts every BatchNorm in
train mode (batch statistics, running statistics updated once per call of
each module) and turns on the head's dropout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from synergynet_tpu_torch.losses import param_loss, wing_loss
from synergynet_tpu_torch.mm3d.assets import ParamPack
from synergynet_tpu_torch.mm3d.codec import decode_landmarks
from synergynet_tpu_torch.nn.backbones import make_backbone
from synergynet_tpu_torch.nn.layers import ExpertDense
from synergynet_tpu_torch.nn.pointnet import MLPFor, MLPRev

REFINE_SCALE = 0.05   # lmk + 0.05 * residual (reference model_building.py:150)

LOSS_WEIGHTS = {       # reference model_building.py:146-155
    "loss_LMK_f0": 0.05,
    "loss_Param_In": 0.02,
    "loss_LMK_pointNet": 0.05,
    "loss_Param_S2": 0.02,
    "loss_Param_S1S2": 0.001,
}


class SynergyNet(nn.Module):
    """``forward((B, S, S, 3) normalized NHWC)`` -> ``((B, 62) params,
    (B, C) feat)``, both fp32; S is 120 as SynergyNet ships, or the side
    the backbone fixes (``backbone.input_size``, a Vision Transformer's).
    ``dropout`` is the head's train-mode rate; its masks come from the
    ``generator`` passed to ``forward``."""

    def __init__(self, arch: str = "mobilenet_v2",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.2,
                 **backbone_kwargs):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.backbone = make_backbone(arch, dtype=dtype, dropout=dropout,
                                      **backbone_kwargs)
        feat_dim = self.backbone.ParamHead_0.fc_pose.in_features
        self.forward_direction = MLPFor(feat_dim)
        self.reverse_direction = MLPRev()

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.backbone(images, generator)

    def refine(self, lmk: torch.Tensor, feat: torch.Tensor,
               shape_code: torch.Tensor, exp_code: torch.Tensor
               ) -> torch.Tensor:
        """Landmarks (B, 3, 68) -> refined landmarks (B, 3, 68)."""
        residual = self.forward_direction(lmk.transpose(1, 2), feat,
                                          shape_code, exp_code)
        return lmk + REFINE_SCALE * residual.transpose(1, 2)

    def reverse(self, lmk: torch.Tensor) -> torch.Tensor:
        """Refined landmarks (B, 3, 68) -> (B, 62) parameters."""
        return self.reverse_direction(lmk.transpose(1, 2))


@torch.no_grad()
def init_synergy_(model: nn.Module, generator: torch.Generator
                  ) -> nn.Module:
    """Draw every parameter of ``model`` as flax initializes the JAX tree:
    conv and dense kernels lecun-normal (a normal truncated at two standard
    deviations, rescaled to variance 1 / fan_in; each stacked expert's
    kernel over its own fan-in, a router's too), biases zero, BatchNorm
    scale 1 (0 where the module sets ``zero_init``, as flax's
    ``scale_init=zeros`` in ResNet's blocks) and bias 0, running mean 0
    and variance 1; LayerNorm scale 1 and bias 0; a Vision Transformer's
    class token 0 and position embedding normal with standard deviation
    0.02, as the ViT paper's released code draws them. In place; the draws
    come from ``generator`` (on the parameters' device)."""
    for m in model.modules():
        if hasattr(m, "pos_embedding"):
            m.cls.zero_()
            nn.init.normal_(m.pos_embedding, 0.0, 0.02, generator=generator)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()           # (in / groups) * kh * kw
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ExpertDense):
            std = math.sqrt(1.0 / m.weight.shape[1]) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif hasattr(m, "running_var"):
            m.weight.fill_(0.0 if getattr(m, "zero_init", False) else 1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def init_synergy_variables(model: SynergyNet, generator: torch.Generator
                           ) -> dict:
    """:func:`init_synergy_` on ``model``, then its weights as the JAX
    package's flax variable tree (``{"params", "batch_stats"}`` of numpy
    arrays), the form that checkpoints and ``SynergyNet3DMM`` take."""
    from synergynet_tpu_torch.convert import flax_from_state_dict
    init_synergy_(model, generator)
    return flax_from_state_dict(model.state_dict())


def synergy_criterion(model: SynergyNet, images: torch.Tensor,
                      target62: torch.Tensor, pack: ParamPack,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 5-term synergy training loss (reference model_building.py:
    141-157) -> ``(total, losses)``; the total is the plain sum of the
    weighted terms. In train mode every BatchNorm of the backbone and of
    the two MLPs runs once, so each module's running statistics move once,
    as the JAX criterion's merged updates do."""
    pred62, feat = model(images, generator)
    target62 = target62.float()
    lmk = decode_landmarks(pred62, pack)
    with torch.no_grad():
        lmk_gt = decode_landmarks(target62, pack)
    w = LOSS_WEIGHTS
    losses = {
        "loss_LMK_f0": w["loss_LMK_f0"] * wing_loss(lmk, lmk_gt),
        "loss_Param_In": w["loss_Param_In"] * param_loss(pred62,
                                                         target62).mean(),
    }
    lmk_refined = model.refine(lmk, feat, pred62[:, 12:52],
                               pred62[:, 52:62])
    losses["loss_LMK_pointNet"] = (w["loss_LMK_pointNet"]
                                   * wing_loss(lmk_refined, lmk_gt))
    pred62_s2 = model.reverse(lmk_refined)
    losses["loss_Param_S2"] = w["loss_Param_S2"] * param_loss(
        pred62_s2, target62, mode="only_3dmm").mean()
    losses["loss_Param_S1S2"] = w["loss_Param_S1S2"] * param_loss(
        pred62_s2, pred62, mode="only_3dmm").mean()
    total = sum(losses.values())
    return total, losses
