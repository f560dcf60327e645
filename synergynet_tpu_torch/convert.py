"""The weight bridge: flax variable trees <-> the port's ``state_dict``s.

A flax tree is a nested dict of arrays, ``{"params": ..., "batch_stats":
...}``. The port's modules carry the flax module names, so a leaf's torch
key is its flax path joined by dots with the leaf renamed:

- ``kernel`` (conv, HWIO) -> ``weight`` (OIHW); a depthwise ``(3, 3, 1, C)``
  kernel becomes ``(C, 1, 3, 3)`` by the same transpose;
- ``kernel`` (Dense, ``(in, out)``) -> ``weight`` (Linear, ``(out, in)``);
- BatchNorm and LayerNorm ``scale`` / ``bias`` and BatchNorm ``mean`` /
  ``var`` -> ``weight`` / ``bias`` / ``running_mean`` / ``running_var``;
- a Vision Transformer's learned embeddings ``cls`` (1, 1, D) and
  ``pos_embedding`` (1, T, D) keep their names and layouts.

Leaves may be numpy arrays or anything ``np.asarray`` reads (the JAX
package's trees); this module never imports jax. :func:`flax_from_state_dict`
goes back, from the port's tensors to a flax-shaped numpy tree (the rank of
a ``weight`` tells a conv (4), a dense (2) and a norm's scale (1) apart).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
EMBEDDINGS = ("cls", "pos_embedding")


def _walk(tree: dict, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _param_leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
        if arr.ndim == 2:
            return "weight", arr.T                          # (in,out) -> (out,in)
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")
    if name == "scale":
        return "weight", arr
    if name == "bias" or name in EMBEDDINGS:
        return name, arr
    raise ValueError(f"unknown flax param leaf {name!r}")


def state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """Every leaf of ``variables["params"]`` and
    ``variables["batch_stats"]`` copied into an fp32 tensor under its torch
    key."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables.get("params", {})):
        leaf, val = _param_leaf(path[-1], arr)
        out[".".join(path[:-1] + (leaf,))] = torch.tensor(val)
    for path, arr in _walk(variables.get("batch_stats", {})):
        if path[-1] not in _STATS:
            raise ValueError(f"unknown flax batch_stats leaf {path[-1]!r}")
        out[".".join(path[:-1] + (_STATS[path[-1]],))] = torch.tensor(arr)
    return out


SYNERGY_MODULES = ("backbone", "forward_direction", "reverse_direction")


def synergy_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """A SynergyNet flax tree -> the port's ``SynergyNet`` state_dict: the
    backbone and the two synergy MLPs (``forward_direction``,
    ``reverse_direction``)."""
    sub = {col: {k: tree[k] for k in SYNERGY_MODULES if k in tree}
           for col, tree in variables.items()
           if col in ("params", "batch_stats")}
    return state_dict_from_flax(sub)


def _put(tree: dict, path, leaf) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def flax_from_state_dict(state: Dict[str, torch.Tensor]) -> dict:
    """The port's state_dict -> ``{"params": ..., "batch_stats": ...}``
    with numpy leaves under their flax paths (float32, float64 kept): the
    inverse of :func:`state_dict_from_flax`."""
    out: dict = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _STATS.items()}
    for key, t in state.items():
        *path, leaf = key.split(".")
        t = t.detach().cpu()
        arr = (t if t.dtype == torch.float64 else t.float()).numpy()
        if leaf in stats:
            _put(out["batch_stats"], path + [stats[leaf]], arr)
        elif leaf == "weight" and arr.ndim == 4:
            _put(out["params"], path + ["kernel"], arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:
            _put(out["params"], path + ["kernel"], arr.T.copy())
        elif leaf == "weight" and arr.ndim == 1:
            _put(out["params"], path + ["scale"], arr)
        elif leaf == "bias" or leaf in EMBEDDINGS:
            _put(out["params"], path + [leaf], arr)
        else:
            raise ValueError(f"no flax leaf for {key!r} {tuple(arr.shape)}")
    return out


def faceboxes_state_dict(folded_variables: dict) -> Dict[str, torch.Tensor]:
    """A BN-folded, stem_r=8 FaceBoxesNet flax tree (``conv1_s2d8`` present,
    no batch_stats) -> the port's ``FaceBoxesNet`` state_dict."""
    if "conv1_s2d8" not in folded_variables["params"]:
        raise ValueError("expected the folded stem_r=8 tree (conv1_s2d8); "
                         "fold with detect.net.fold_bn_variables and "
                         "fold_to_s2d8 first")
    return state_dict_from_flax(folded_variables)
