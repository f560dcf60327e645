"""Backbone registry. Every backbone returns ``(param62, pooled_feat)``.

The same names and factories as ``synergynet_tpu/nn/backbones/__init__.py``:
MobileNetV2 at widths 1.0, 0.5 and 1.4; MobileNetV1 at six widen factors;
GhostNet; the ResNet, ResNeXt and wide-ResNet variants; ResNeSt at four
depths and its six "fast" ablations; and, in the port alone, the Vision
Transformer ViT-B/16 (``vit_b16``, :mod:`.vit`), its sparse
mixture-of-experts form V-MoE-B/16 (``vmoe_b16``) and HRNetV2-W18 in its
facial-landmark form (``hrnetv2_w18``, :mod:`.hrnet`). Each factory takes
``dtype`` and ``dropout`` (and the family's own options). :func:`register_backbone`
adds a name: ``SynergyNet(arch=name)`` then builds it, and the
checkpoint loaders take it wherever they build the net (a framework
``.npz``; a reference ``.pth.tar`` needs a name mapping of its own).
A registered factory returns a module whose ``forward`` gives
``(param62, pooled_feat)`` and which holds the head as ``ParamHead_0``.
"""

from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from synergynet_tpu_torch.nn.backbones.ghostnet import GhostNet
from synergynet_tpu_torch.nn.backbones.hrnet import HRNet
from synergynet_tpu_torch.nn.backbones.mobilenet_v1 import MobileNetV1
from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import MobileNetV2
from synergynet_tpu_torch.nn.backbones.resnest import (
    RESNEST_FAST_VARIANTS, RESNEST_LAYERS, make_resnest)
from synergynet_tpu_torch.nn.backbones.resnet import RESNET_LAYERS, make_resnet
from synergynet_tpu_torch.nn.backbones.vit import VisionTransformer, vmoe_b16

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "mobilenet_v2": MobileNetV2,
    "mobilenet_v2_0.5": lambda **kw: MobileNetV2(width_mult=0.5, **kw),
    "mobilenet_v2_1.4": lambda **kw: MobileNetV2(width_mult=1.4, **kw),
    "mobilenet_1": MobileNetV1,
    **{f"mobilenet_1_{w}": (lambda w=w, **kw: MobileNetV1(widen_factor=w,
                                                            **kw))
       for w in (0.25, 0.5, 0.75, 1.5, 2.0)},
    "ghostnet": GhostNet,
    **{n: (lambda n=n, **kw: make_resnet(n, **kw)) for n in RESNET_LAYERS},
    **{n: (lambda n=n, **kw: make_resnest(n, **kw))
       for n in (*RESNEST_LAYERS, *RESNEST_FAST_VARIANTS)},
    "vit_b16": VisionTransformer,
    "vmoe_b16": vmoe_b16,
    "hrnetv2_w18": HRNet,
}


def register_backbone(name: str, factory: Callable[..., nn.Module]) -> None:
    """Make ``factory(dtype=, dropout=, **options)`` the backbone of
    ``name``, replacing any earlier one."""
    _REGISTRY[name] = factory


def make_backbone(arch: str, **kwargs) -> nn.Module:
    if arch not in _REGISTRY:
        raise ValueError(
            f"unknown backbone '{arch}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch](**kwargs)


def available_backbones():
    return sorted(_REGISTRY)
