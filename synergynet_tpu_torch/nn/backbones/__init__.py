"""Backbone registry. Every backbone returns ``(param62, pooled_feat)``.

Only ``mobilenet_v2`` (the shipped model) is ported so far; the JAX
package's other backbones are later slices.
"""

from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import MobileNetV2  # noqa: F401

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "mobilenet_v2": MobileNetV2,
}


def make_backbone(arch: str, **kwargs) -> nn.Module:
    if arch not in _REGISTRY:
        raise ValueError(
            f"unknown backbone '{arch}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch](**kwargs)


def available_backbones():
    return sorted(_REGISTRY)
