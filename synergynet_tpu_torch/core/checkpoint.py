"""Checkpoints and the shipped inference weights, numpy only.

Counterpart of ``synergynet_tpu/core/checkpoint.py``. A checkpoint is the
JAX package's format (``:24-80,147-156``): one ``.npz`` of flat
``path/to/leaf`` arrays plus a JSON ``__metadata__`` entry, written to a
temporary file and renamed into place. Trees are nested dicts of numpy
arrays; a training state saved by the port
(:meth:`synergynet_tpu_torch.train.TrainState.tree`) has the JAX
``TrainState``'s leaves (``step``, ``params/...``, ``batch_stats/...``,
``opt_state/<i>/...``), so the JAX ``restore_checkpoint`` reads it.

The trained asset is a flat ``.npz`` of flax leaves (``.params/...``,
``.batch_stats/...``, float16 for size); :func:`load_trained_variables`
rebuilds the nested flax tree with float32 leaves and
:mod:`synergynet_tpu_torch.convert` turns it into the port's
``state_dict``. The file is read where the JAX package ships it,
``synergynet_tpu/assets/trained/``, by plain file access: the port never
imports ``synergynet_tpu``. :func:`load_torch_state_dict` reads a reference
PyTorch checkpoint for :mod:`synergynet_tpu_torch.nn.torch_import`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

_SEP = "/"

_TRAINED_ASSETS = {"mobilenet_v2": "synergynet_mbv2_shaded680k_ep80.npz"}

# Site-packages for a wheel install, the repo root for a checkout: in both
# the JAX package (and its package data) sits beside this one.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _flatten(tree: dict, prefix=()) -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[_SEP.join(prefix + (str(k),))] = np.asarray(v)
    return flat


def save_checkpoint(path: str, tree: dict, *, step: Optional[int] = None,
                    metadata: Optional[dict] = None) -> None:
    """Atomically write a nested dict of arrays to ``path`` (.npz), with
    ``metadata`` (and ``step``) as JSON."""
    meta = dict(metadata or {})
    if step is not None:
        meta["step"] = int(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, __metadata__=json.dumps(meta), **_flatten(tree))
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: dict) -> dict:
    """The checkpoint at ``path`` in the structure of ``template``: every
    leaf must be present with the template's shape, and takes its dtype."""
    with np.load(path, allow_pickle=False) as z:
        # Checkpoints of the JAX package may carry a leading dot on state
        # fields (``.params/...``).
        flat = {_SEP.join(c.lstrip(".") for c in k.split(_SEP)): z[k]
                for k in z.files if k != "__metadata__"}

    def fill(node, prefix):
        out = {}
        for k, v in node.items():
            key = prefix + (str(k),)
            if isinstance(v, dict):
                out[k] = fill(v, key)
                continue
            name = _SEP.join(key)
            if name not in flat:
                raise KeyError(f"checkpoint missing leaf '{name}'")
            arr = flat[name]
            if arr.shape != np.shape(v):
                raise ValueError(f"shape mismatch for '{name}': ckpt "
                                 f"{arr.shape} vs {np.shape(v)}")
            out[k] = arr.astype(np.asarray(v).dtype)
        return out

    return fill(template, ())


def checkpoint_metadata(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if "__metadata__" in z.files:
            return json.loads(str(z["__metadata__"]))
    return {}


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


def load_shipped_trained(arch: str = "mobilenet_v2") -> Dict[str, Any]:
    """The shipped full-recipe weights of ``arch`` as flax variables (see
    :func:`load_trained_variables`); raises as
    :func:`shipped_trained_path` does for an arch with no shipped run."""
    return load_trained_variables(shipped_trained_path(arch))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference PyTorch checkpoint (``best.pth.tar``) -> its state_dict as
    numpy arrays: a ``{"state_dict": ...}`` wrapper is unwrapped and any
    DataParallel ``module.`` prefix stripped. Read as the JAX package reads
    it, with ``torch.load(..., weights_only=False)``: the file is unpickled
    whole, so load only checkpoints from a trusted source."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k.removeprefix("module."): v.detach().cpu().numpy()
            for k, v in ckpt.items() if hasattr(v, "numpy")}
