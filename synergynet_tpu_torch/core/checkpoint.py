"""Loading the shipped inference weights, numpy only.

Counterpart of ``synergynet_tpu/core/checkpoint.py:82-144``. The trained
asset is a flat ``.npz`` of flax leaves (``.params/...``,
``.batch_stats/...``, float16 for size); this rebuilds the nested flax
tree with float32 leaves. :mod:`synergynet_tpu_torch.convert` turns that
tree into the port's ``state_dict``. The file is read where the JAX package
ships it, ``synergynet_tpu/assets/trained/``, by plain file access: the
port never imports ``synergynet_tpu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

_SEP = "/"

_TRAINED_ASSETS = {"mobilenet_v2": "synergynet_mbv2_shaded680k_ep80.npz"}

# Site-packages for a wheel install, the repo root for a checkout: in both
# the JAX package (and its package data) sits beside this one.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_trained_variables(path: str) -> Dict[str, Any]:
    """An exported inference asset -> flax variables
    ``{"params": ..., "batch_stats": ...}`` with float16 leaves upcast to
    float32."""
    out: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k == "__metadata__":
                continue
            parts = k.split(_SEP)
            col = parts[0].lstrip(".")
            if col not in ("params", "batch_stats"):
                continue
            node = out.setdefault(col, {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            arr = z[k]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node[parts[-1]] = arr
    if "params" not in out:
        raise ValueError(f"{path} holds no '.params/' leaves — not an "
                         "exported inference asset")
    return out


def shipped_trained_path(arch: str = "mobilenet_v2") -> str:
    """Path of the shipped trained asset for ``arch``; raises for archs
    without a shipped run or when the JAX package's data is missing."""
    if arch not in _TRAINED_ASSETS:
        raise ValueError(
            f"no shipped trained weights for arch {arch!r} "
            f"(have: {sorted(_TRAINED_ASSETS)})")
    path = os.path.join(_PKG_PARENT, "synergynet_tpu", "assets", "trained",
                        _TRAINED_ASSETS[arch])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"shipped trained asset missing at {path} — the synergynet_tpu "
            "package data is not beside this package")
    return path
